from .client import KektorDBClient, KektorDBError, Task  # noqa: F401
from .cognitive import CognitiveSession  # noqa: F401
