from .aniso import ANISO_PAIR_POTENTIALS, AnisoPairPotentialDef, two_patch_morse  # noqa: F401
from .bond import BOND_POTENTIALS, BondPotentialDef  # noqa: F401
from .pair import PAIR_POTENTIALS, PairPotentialDef, perturbed_lennard_jones  # noqa: F401
from .barrier import BARRIERS, BarrierDef  # noqa: F401
from .wall import WALL_POTENTIALS, WallPotentialDef  # noqa: F401
