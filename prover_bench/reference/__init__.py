"""The plain reference that decides ``correct``: a verifier of halo2 proofs
over KZG/BN254 that knows the SRS's secret, and the verifying key worked out
from each configuration's own account of its circuit (``configs/``).  It is
plain Python and imports neither torch nor anything of the port.
"""
