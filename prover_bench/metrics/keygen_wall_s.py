"""keygen_wall_s: seconds of set-up's one keygen_vk + keygen_pk, after the
SRS, fenced by ``torch.cuda.synchronize`` (host clock); it pays the domain's
tables.  Layer: keygen (plonk/keygen.py, the circuit's synthesis without a
witness, the fixed and permutation commitments).  It moves setup_s, of which
it is a part."""


def read(data):
    return data.keygen_s
