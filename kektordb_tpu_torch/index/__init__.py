from .bruteforce import BruteForceIndex  # noqa: F401
from .hnsw import HNSWConfig, HNSWIndex  # noqa: F401
from .hostarena import HostArenaIndex  # noqa: F401
