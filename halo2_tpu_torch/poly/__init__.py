from .polynomial import COEFF, EXTENDED, LAGRANGE, Poly, Rotation
from .domain import EvaluationDomain
