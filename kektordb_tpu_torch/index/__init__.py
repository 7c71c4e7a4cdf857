from .bruteforce import BruteForceIndex  # noqa: F401
from .hnsw import HNSWConfig, HNSWIndex  # noqa: F401
