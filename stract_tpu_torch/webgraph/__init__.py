from .edge import Edge, RelFlags
from .node import Node
from .store import Webgraph, WebgraphBuilder
