from .pair import PAIR_POTENTIALS, PairPotentialDef, perturbed_lennard_jones  # noqa: F401
