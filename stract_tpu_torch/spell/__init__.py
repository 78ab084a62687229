from .term_freqs import TermFreqs
from .stupid_backoff import StupidBackoff
from .checker import SpellChecker, Correction
from .trainer import FirstTrainer, SecondTrainer
