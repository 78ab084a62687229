from .calculator import Calculator
from .thesaurus import Thesaurus
from .manager import WidgetManager
