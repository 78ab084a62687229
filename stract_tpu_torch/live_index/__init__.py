"""The freshness tier — the port of stract_tpu/live_index/: the write-ahead
log, the live index (TTL'd segments compacted by the hour) and the live
crawler that feeds it."""

from .wal import Wal
from .index import LiveIndex
from .crawler import LiveCrawler, SiteChecker
