from .html import Html
from .core import Webpage
from .region import Region
