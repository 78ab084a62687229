from .hashing import fnv1a64, splitmix64, combine_u64s, prehash
from .kahan import KahanSum
