"""The crawl roles — the port of stract_tpu/crawler/: robots.txt, the on-disk
job queue, the coordinator, the router, the workers and the planner (host
work all; a queue either package writes, the other reads)."""

from .robots import Robots
from .coordinator import CrawlCoordinator, Job, UrlToInsert
from .router import Router
from .worker import WorkerThread, JobExecutor
from .planner import make_crawl_plan
