from . import rng, variant
from .box import Box
from .snapshot import Snapshot
from .state import State, state_from_snapshot, state_to_snapshot, thermalize_momenta
from .typeparam import TypeParameter
