from .sonic import Server, RemoteClient, RpcError, serve_in_thread, free_socket_addr
from .cluster import Cluster, Member, Service
from .replication import (
    ReplicatedClient,
    ShardedClient,
    RandomReplicaSelector,
    AllReplicaSelector,
    SpecificReplicaSelector,
    AllShardsSelector,
    SpecificShardSelector,
)
