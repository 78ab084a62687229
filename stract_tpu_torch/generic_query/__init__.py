"""Generic two-phase distributed queries — the port's copy of
stract_tpu/generic_query/ over the port's LocalSearcher (role of reference generic_query/,
1,345 LoC: the GenericQuery trait — search phase producing mergeable fruits,
coordinator merge, retrieve phase — generic_query/mod.rs:58-80, flow :17-35).

Implementations mirror the reference's: SizeQuery, GetWebpageQuery,
GetHomepageQuery, GetSiteUrlsQuery, TopKeyPhrasesQuery."""

from .query import (
    GenericQuery,
    SizeQuery,
    GetWebpageQuery,
    GetHomepageQuery,
    GetSiteUrlsQuery,
    TopKeyPhrasesQuery,
    run_generic_query,
)
