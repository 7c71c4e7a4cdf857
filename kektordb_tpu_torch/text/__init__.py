from .analyzer import analyze, tokenize  # noqa: F401
from .stemmer_en import stem_english  # noqa: F401
from .stemmer_it import stem_italian  # noqa: F401
