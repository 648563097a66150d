from .bond import BOND_POTENTIALS, BondPotentialDef  # noqa: F401
from .pair import PAIR_POTENTIALS, PairPotentialDef, perturbed_lennard_jones  # noqa: F401
