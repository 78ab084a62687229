from .dht import DhtShard, DhtClient, upsert
from .coordinator import Coordinator
from .worker import Worker
from .job import Job, Mapper, Setup, Finisher
from .dht_conn import DhtConn, DhtTable
