"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Builds the CUDA kernels from stract_tpu_torch/csrc, builds (or reuses) a
1,000,000-doc synthetic corpus under data/torch_smoke/, holds each kernel
against its plain PyTorch version at the main path's shapes (K1 in each of
its table forms and in a batch that mixes them, two calls bit-equal; K1 and
K2 also timed with numpy slots, as the index calls them), then serves the
corpus over HTTP in process (stract_tpu_torch.main) and drives the search
route: every answer must be a 200 with webpages, every kernel must have been
launched by that traffic, and the top-10 of sample queries must match the
same stack run with the plain versions on the card.

Then optics, the shard's linear model and the side answers on the same
stack: the optic bodies of OPTICS (a DiscardNonMatching site, whose site
group drives stage B; a discarded site; three discarded wildcard site
patterns, 333 excluded slots of ~2,000 postings, past L; likes, dislikes
and a boost, the coordinator's residual) on a rare-term query (the driver
path), a head-term query (the scan path) and its fifth page of 20 (pass 2),
served over HTTP (every request answered, the configuration's kernels
launched), then each first page searched alone with every scoring launch
timed and its table recorded (K1's form, slots and entries; K13's P; K2's
and K11's P and Kd; K3's P and K) and against the plain versions (top-10s
by compare_phase's rule); an O1 page holds site7.com alone, an O2 or O3
page no discarded site, and O3's head-term query must take K1's global
form at T >= 524,288 (and K13 its P = 512 bucket under the merge: the
merge and join configurations run the same phase in their rounds). A
LinearRegression with seeded weights in a SearchService (pass 2 at search
time: K3 launched) gives the plain versions' top-10s; the widget, spell
check, autosuggest and sidebar routes answer over HTTP.

Then the coordinator's whole page (page_phase): a seeded ZIM of 100,000
articles (titles from the corpus's vocabulary, every tenth with an infobox
image) written by the port's ZimWriter, `main.py indexer entity` as a
process (timed) while the page graph (the corpus's 1,000,000 URLs, the
centrality job's 20,000,000 edges) and the host graph (its 500 sites) are
written, `main.py entity-search-server` as a process joined to gossip, and
the coordinator on the card without an entity index: its sidebar and entity
images come from that server (RemoteSidebarManager, RemoteEntityImageStore,
as entrypoint/api.py page_services wires them). Over HTTP at 16 clients the
request mix alone, then mixed with a sidebar request on each query, 32
requests on each link route (hosts and pages, in and out), 32 entity images
(half misses), browser autosuggest, the improvement routes, health, the
spec and the UI: every sidebar answer must be a local SidebarManager's over
the same index or, without an entity, the StackOverflow search's; every
link route the graph's edges; every image hit the store's bytes; K1-K3
launched by that traffic; and search_websites (the object path) must give
the batched path's top-10s on the compare queries, launching K1 and K2.
`[result page]` prints the build times, the sidebar's p50 and p99 on entity
hits and on misses (the search on the card), each route's p50 and the mixed
round's qps beside the mix's alone.

Then the ranking pipeline: a 30,522-piece WordPiece vocab fit on the corpus;
the train phase trains MiniLM-L6 dual and cross encoders on the card from
triples synthesised from the corpus (stract_tpu_torch.entrypoint.
train_bench_encoders at its defaults: 400 steps, dual batch 64, 128 tokens,
4,096 triples; then the cross encoder warm-started from the dual trunk and
distilled from it), saves both and loads them back, and fails when the dual
encoder's held-out accuracy is under 0.65; every training kernel (K14a-d,
K5d, both loss heads of K15c) and the forward kernels (K5a-c) must be
launched by that training. A 40-tree depth-3 forest is trained on the
pipeline-off signal rows. The
trained dual encoder writes the corpus's embedding columns on the card; the
forest (K4), encoder (K5a-d) and training (K14a-d) kernels are held against
their plain versions (K14b at the widths 64, 384 and 768; K14c at 1,536 and
3,072, at 1,000 and on a misaligned view, two calls bit-equal), and one whole
train step is timed with kernels and
with plain versions; the stack is served again with the three models loaded
as `main.py serve --dual-encoder/--cross-encoder/--lambdamart` loads them,
every serving kernel must be launched by that traffic, and its top-10 pages
must match the plain versions'.

Between the training and the kernel checks, the port builds its own index
(index_phase): 2 seeded WARC files of 1,000 pages over 500 hosts written by
the port's WarcWriter (stract_tpu_torch/warc_corpus.py: titles with a token
of their own, descriptions, h1-h3, 300-1,500 words of paragraphs, 20-60
links with some rel flags, JSON-LD on 1 in 10, microdata on 1 in 20,
robots noindex on 1 in 50), their host graph, its harmonic centrality on
the card (K6a / K6b launched), entrypoint/indexer.py run with that
centrality and the trained dual encoder on the card (K5a-d launched by the
title and keyword embeddings), two commits and merge_all, while `main.py
indexer search` and `indexer canonical` run on the first file as
processes. The doc count must be the pages less the noindex ones, the
merged segment's docs, terms (the union), postings and stored docs those
of the two segments, the stored title embeddings the f16 of what embed()
gave, and the stemmer live (stem('running') == 'run'). The index is served
through build_searcher with the dual encoder in recall: 64 sampled pages
found at rank 1 by their own title token, a round of 32 queries (stop-word
pairs and triples on the scan path, stems and title words on the driver
path, deep pages) launching K1-K3, its top-10s the plain versions'.
`[result index]` prints the counts, each stage's seconds, pages/s and the
launches.

Then the freshness tier (live_phase): a fake web of 50 seeded sites of 20
pages (warc_corpus.py pages under seed 27, 80-300 words; 60 % published
before the crawl, the rest over 26 simulated hours) on an http.server at
127.0.0.1, each with an RSS or Atom feed, a sitemap (every fifth a
sitemapindex; raw `&` in some locs), a front page and a robots.txt; two
live-index replicas of shard 0 on the card (entrypoint/live_index.py run,
sonic, gossip) fed by a LiveCrawler through LiveIndexClient(0.5), the
replicas ticking every 10 simulated minutes (~150 autocommits, hourly
compaction); the coordinator (entrypoint/api.py) over gossip with the index
phase's index as its search shard. Before compaction, after it and after a
jump past the 60-day TTL: 64 HTTP queries whose pages each hold a live
candidate (shard >= LIVE_SHARD_OFFSET), 64 queries' top 10 from replica 0
against a CPU LiveIndex on a copy of its directory (rtol / atol 1e-3), K1-K3
launched by the live shard's own searches; card memory after the last
compaction-and-prune cycle within one segment's device copy of the first's;
a quorum write with a replica down (0.5 acks, 1.0 raises); `main.py
live-index serve` as a process answering a search found by gossip; the
crawl roles (coordinator, router, worker over sonic) crawling 5 sites into
WARC files, robots obeyed. `[result live]` prints the stages' seconds, the
segment counts and the launches.

The pipeline-on route serves 8 rounds of the request mix in one process,
and every request must be answered.

Then the shapes past the smoke's own models: two seeded LightGBM dumps (500
trees of 31 leaves, LightGBM's default, and 1,000 of 255) written as text
and read back as `--lambdamart` reads them, each past one block's shared
memory, so K4 walks it in chunks of trees, held bit-equal to the tree-order
f32 sum at 16,384 rows; the 500-tree text is served one pipeline-on HTTP
round through build_searcher's lambdamart path. K5a, K14a and K5d past 512
tokens against their plain versions (1,024 and 2,048 tokens at MiniLM's
heads, 16,384 tokens of 2 heads of 64; the pool at 1,024 and 4,096 tokens),
and 3 train_dual_encoder steps at max_len 1,024 on MiniLM-L6 at full width,
batch 8. The pipeline phase below holds K16a-b also at T = 2,048 and at
H = 1,536 and 2,048, and records its step's bound.

Then the webgraph centrality job (entrypoint/bench_centrality.py's graph:
1,000,000 nodes, 20,000,000 Pareto edges, seed 0, written to disk): `main.py
centrality harmonic` and `approx-harmonic` (256 sampled sources) on the card
through the function the command line calls; every HyperBall kernel (K6a
merge, K6b estimate) and the BFS relaxation (K7) must be launched by them;
the kernels are held against their plain versions at the job's shapes, and
the whole HyperBall and BFS against the same jobs through the plain
versions.

Then the shard search's other configurations, each built through
build_searcher and served one round of the request mix over HTTP with the
pipeline off: q8 posting rows, the device factor join, both, and block-max UB
scoring (ub_lambda 0.5); every request must be answered, each configuration's
own kernels launched by its traffic, and the top-10 of the compare queries
under the q16 device join must equal the default configuration's. The host
factor join is timed with and without the device join. The device-only entry
points, which no entry point of either package calls (factors_join, compute_signals_batch over the slots' L-row prefixes,
rerank_topk_batch over the corpus's f16 title embeddings and the trained dual
encoder's query embeddings) are driven once at the main shapes and checked
against the host join and a numpy rerank; then K1 on q8 rows, K1 with UB,
K11 (alone, in stage B, in pass 2), K12 and K10 are held against their plain
versions, the joined stage B and pass 2 also against K2 and K3 over the host
join bit for bit (pass 2 at K = 128 and 512, q16 and f32 rows), and K11 on a
batch that crosses its plan's length threshold (an empty slot, a one-row
slot, the last posting list, a range ending at the card array's last row,
duplicate and pad candidates). The merge configuration (merge_kernel: stage A through the P-way
bitonic merge, K13) is served the same round; its top-10 pages must match
the same configuration run with the plain versions on the card (how many
equal the default's is printed, not gated: on the impact slots' tf-ordered
rows the merge gives other candidates, by design of the reference), and K13
is held against its plain version at B = 32, P = 64, L = 1024, C = 4096 with
the network's keys and payloads bit-equal. The verify configuration
(verify_c 1024: stage A's candidates cut to their top 1,024 before the exact
verify) is served the same round; its top-10 pages must hold finite scores
in order, and the (doc, score) pairs they share with the default's are
printed, not gated (a default top-10 document may rank below 1,024 in stage
A).

Then the MoE training path: a MiniLM-L6 cross encoder at full width with 4
experts per layer (make_train_state(num_experts=4); the shared trunk
warm-started from the trained dual encoder), 20 distilled steps at 32 pairs
x 128 tokens on the smoke's triples, launch counts reset just before and
read just after: the loss must be finite and fall (mean of the last 5 steps
under the mean of the first 5), the router (K15a), select-and-scale (K15b),
the pair head (K15c) and bf16 AdamW (K15d) must be launched by those steps,
and the same 20 steps through the plain versions on the card must give the
same loss curve within 5 % per step; one step is timed with kernels and
with plain versions, and K15a-d are held against their plain versions at
the step's shapes (K15a's whole VJP, the router's parameter gradients
included, two calls bit-equal; K15c's pair head plain and distilled at 32
pairs, its InfoNCE head at 32, 64 and 256 rows, two calls bit-equal).

Then the pipeline-parallel train step (parallel/pipeline.py, K16) at
MiniLM-L6's width: six single-head f32 stages (hidden 384, FFN 1536, 128
tokens) on a (pp=6, dp=2) Mesh of entries of the card, 8 microbatches of 16
rows from a numpy seed. K16a-d (the stage's attention, its backward, the
tanh GELU forward and backward, the SGD update) are held against their
plain versions at the step's shapes (K16a-b also at T = 512 and at H =
1,024) and timed beside SDPA in f32, its backward through autograd, F.gelu
and torch._foreach_add_; the pipelined forward against
reference_forward through the plain versions (rtol 2e-4, atol 2e-5); 20
SGD steps at lr 5e-2 with the kernels, launch counts reset just before and
read just after (every K16 kernel launched, the loss finite), beside the
same 20 steps through the plain versions from the same parameters (the
curves within 1e-3 per step); a step timed with each, in turns.

Then the mesh of shards on the card (parallel/mesh.py: Mesh([cuda:0] * 4)):
a 4-segment index of 4 x 250,000 pages (seeds 1-4, written by four child
processes while the main corpus is built) served by a search shard server
(entrypoint/search_server.py run, sonic RPC) on the mesh, the coordinator
(entrypoint/api.py, found by gossip) and the HTTP server in front; one round
of the request mix, launch counts reset just before and read just after:
every request answered, K1, the joined stage B, pass 2 and the mesh's
global top-k (K9) launched; then the same index without a mesh serves the
same round, and the 8 compare queries' pass-1 top-10s (rtol 1e-5, docs up to
ties) and top-10 pages must agree; K9 is held against its plain version at
(4, 512), (4, 1024) and (8, 1024) with planted ties, bit-equal, and timed
beside torch.topk and the two gathers that give the docs and shards. After
the centrality phase, `run_harmonic(mesh=)` over 4
register shards of the 1M-node graph (counts reset before, read after: K8
and K6b launched): the same rounds and centrality as the single-card job;
its rounds again against K6a, every round's registers bit-equal; K8 on one
(shard, step) bucket bit-equal to its plain version.

Then the rest of the graph (graph_roles_phase): `main.py webgraph create` over
2 seeded WARC files of 150 pages (page level) and `webgraph merge`; the two
graphs served as webgraph shards found by gossip, shard 1 by `main.py
webgraph-server` as a process: RemoteWebgraph answers 48 sampled nodes' every
method as the merged graph does. The AMPC harmonic job on bench_centrality's
graph cut to 10,000 nodes and 200,000 edges (the job's DHT is Python dicts
behind sonic RPC, one msgpack pair a key): 2 DHT shards, 4 harmonic workers
on the card and the coordinator of entrypoint/ampc.py over gossip, counts
reset just before and read just after (K6a launched rounds x 4 times); the
same job with CPU workers beside a stopped worker of shard 0, bit-equal; both
within 1e-4 of `main.py centrality harmonic` on the card. Shortest paths over
4 shortest-path workers equal K7's BFS; approx-harmonic over 4 sources equals
the single-card approx-harmonic within rtol 1e-12; a 3-replica raft group
keeps taking writes after its leader is stopped. `[result graph roles]`
prints each part's seconds, the rounds and K6a's launches, and K6a's record
in the kernels line gains `ampc_launches`.

Prints per-kernel times beside the least time the card could take (bytes
once over 3.35 TB/s or operations over the peak) and the time of a PyTorch
call computing the same function where there is one, qps, p50 and p99, the
centrality jobs' stage times, and as its last line the device record. Any
failure raises, so the exit code is non-zero; without a card it exits 2
before doing anything; it fails when the native host library does not
load. Every phase runs under `in_phase`, which prints `[<phase>] FAILED:
<type>: <message>` to stderr before the exception propagates, so a failed
run names its phase. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
DOCS = 1_000_000
SEED = 0
NOW = 1.7e9
# main-path shapes of the three programs
B, L, C, KD, OUT_K, SIG_K, PAGE_K = 32, 1024, 4096, 4096, 1024, 64, 128
N_REQUESTS, CLIENTS = 128, 16
CUSTOM = {"host_centrality": 3.0, "bm25_clean_body": -0.2}
# the ranking pipeline: vocab, tokenizer sample, forest training queries,
# encoder batch of the kernel phase, sequence lengths, forest rows
VOCAB, TOK_DOCS, FOREST_QUERIES, ENC_B = 30522, 20_000, 32, 32
ATTN_T, ENC_T, FOREST_K, EMB_BATCH = (16, 65, 128, 200, 256), 128, (1, 255, 256, 16384), 4096
# K4 also on a forest walked past max_depth: trees of FOREST_DEEP levels
# evaluated at 3, two negative feature indices
FOREST_DEEP, FOREST_DEEP_TREES = 5, 12
# K5a and K14a over every head dim they take (BertConfig.tiny's 16, MiniLM's
# 32, BERT-base's 64) at tile tails below, at and past the 256 tokens of
# their one-pass forms and at 512, for a batch of GRID_B x 12 heads
GRID_D, GRID_T, GRID_B = (16, 32, 64), (1, 65, 256, 257, 512), 8
# BERT-base width (BertConfig(): 12 layers, 768 wide, 12 heads of 64): one
# embedded batch at the dual encoder's 256 tokens, two training steps at 512
BASE_EMBED_B, BASE_TRAIN_B, BASE_TRAIN_T, BASE_STEPS = 8, 4, 512, 2
# training: the dual encoder's batch and length (the kernel phase's shapes),
# the held-out bar of tools/train_bench_encoders.py, and the step count
# (the tool's default; cut, and the cut printed, if training outgrows the run)
TRAIN_B, TRAIN_T, MIN_DUAL_ACC, TRAIN_STEPS = 64, 128, 0.65, 400
SCORING = ("stage_a", "stage_b", "signals_q16")
# the shard search's other configurations (build_searcher's arguments) and the
# kernels each one's traffic must launch
CONFIGS = {
    "q8": (dict(row_layout="q8"), ("stage_a_q8", "stage_b", "signals_q16")),
    "join": (dict(device_join=True), ("stage_a", "stage_b_joined", "signals_joined")),
    "q8_join": (dict(row_layout="q8", device_join=True),
                ("stage_a_q8", "stage_b_joined", "signals_joined")),
    "ub": (dict(ub_lambda=0.5), ("stage_a_ub", "stage_b", "signals_q16")),
    "merge": (dict(merge_kernel=True), ("stage_a_merge", "stage_b", "signals_q16")),
    "verify": (dict(verify_c=1024), ("stage_a", "stage_b", "signals_q16")),
}
# device programs that no entry point of either package calls (the JAX package
# keeps them as library functions): the smoke calls each wrapper once at the main
# shapes, so their `launches` show that the wrapper launches, not a served path
DIRECT = ("factors_join", "signals_prefix", "dense_rerank")
# the dense rerank: candidates per query, kept, the similarity's weight; the
# candidates and dims of its check past the old kernel's limits (k = K)
RERANK_K, RERANK_TOP, RERANK_W = 1024, 20, 0.01
RERANK_LONG = (5000, 1536)
# optics on the corpus's sites (bench_corpus.py: site0.com ... site499.com):
# a DiscardNonMatching site (its required group can drive stage B), a
# discarded site, three discarded wildcard patterns (111 sites each, 333
# excluded slots of ~2,000 postings: past L), likes / dislikes and a boost
# (the residual on the host)
OPTICS = {
    "O1": 'DiscardNonMatching; Rule { Matches { Site("|site7.com|") } };',
    "O2": 'Rule { Matches { Site("|site3.com|") }, Action(Discard) };',
    "O3": 'Rule { Matches { Site("site1") }, Matches { Site("site2") }, '
          'Matches { Site("site3") }, Action(Discard) };',
    "O4": 'Like(Site("site5.com")); Dislike(Site("site6.com")); '
          'Rule { Matches { Site("|site8.com|") }, Action(Boost(3)) };',
}
# what O3's head-term query must reach: K1's global form at T of at least
# this many slots (default and join), K13 this P bucket (merge)
OPTIC_GATE = {"default": ("stage_a", 524_288), "join": ("stage_a", 524_288),
              "merge": ("stage_a_merge", 512)}
# the shard's linear model: its signals and their seeded weights' scale
LINEAR_SIGNALS = ("host_centrality", "bm25_title", "bm25_clean_body", "title_coverage",
                  "fetch_time_ms")
SERVING = SCORING + ("forest", "attention", "add_layernorm", "bias_gelu", "mean_pool")
# the coordinator's whole page: a seeded ZIM of PAGE_ENTITIES articles (the
# low end of the reference's 1e5-1e6 entity corpora; every tenth with an
# infobox image) whose titles come from the corpus's w<N> vocabulary: the
# mid-frequency terms below PAGE_ENTITY_TERMS (a query whose mid term lies
# past it finds no entity and falls through to the StackOverflow search on
# the card) and every fourth request of the mix's query as a title; the page
# graph over the corpus's URLs with the centrality job's 20M edges, the host
# graph over its sites; PAGE_LINKS requests on each link route, PAGE_IMAGES
# on the entity image route (half of them misses)
PAGE_ENTITIES, PAGE_ENTITY_TERMS, PAGE_IMAGE_EVERY = 100_000, 10_150, 10
PAGE_HOST_EDGES, PAGE_LINKS, PAGE_IMAGES = 50_000, 32, 32
TRAINING = ("attention", "add_layernorm", "bias_gelu", "mean_pool", "attention_backward",
            "add_layernorm_backward", "bias_gelu_backward", "adamw", "info_nce", "pair_loss")
# K15c's two heads: their launches are counted over every path that runs one
# (the dual encoder's InfoNCE steps, the cross encoder's and the MoE's pair
# steps, main.py train-encoders)
LOSS_HEADS = ("pair_loss", "info_nce")
# K15c's InfoNCE head held against its plain version at these rows (the
# train-encoders default, the dual step's, a large batch)
INFO_NCE_B = (32, 64, 256)
# the centrality job: the benchmark graph (entrypoint/bench_centrality.py)
# and the sampled sources of approx-harmonic
GRAPH_NODES, GRAPH_EDGES, GRAPH_SAMPLES = 1_000_000, 20_000_000, 256
# HLL precisions past the job's 6 that the JAX package computes (a config's
# `precision`): 2, 2,048 and 4,096 registers a row, K6a, K6b and K8 held to
# their plain versions there on the 2,000-node graph
HLL_PRECISIONS = (1, 11, 12)
WIDE_SAMPLES = 1_100  # K7 past 1,024 sources (two chunks of 32 words)
# pipeline-on serving: rounds of the request mix in one process
SERVE_ON_ROUNDS = 8
# K13 held against its plain version: slots per query (the index's larger
# stage-A bucket: the global form at L = 1,024), and past 2 blocks' shared
# memory for the select's keys
MERGE_P, MERGE_WIDE_P = 64, 256
# K12 held against its plain version also over this many full-length slots a
# query (their L-row prefixes pass one block's staging)
PREFIX_WIDE_P = 64
# K3 held against its plain version at these pages (its main path's 128 and
# 512, and the ends of what it takes)
PASS2_K = (1, PAGE_K, 512, C)
# the MoE training path: experts per layer, distilled steps, pairs per step,
# the smoke's cross recipe (lr, distillation weight, teacher scale), the
# steps timed; the kernels the steps must launch
MOE_E, MOE_STEPS, MOE_B, MOE_LR, MOE_ALPHA, TEACHER_SCALE = 4, 20, 32, 3e-4, 2.0, 5.0
MOE_TIMED = 3
MOE_KERNELS = ("moe_router", "moe_select", "pair_loss", "adamw_bf16", "adamw")
# the index build: 2 WARC files of 1,000 pages over 500 hosts (a Common Crawl
# file holds tens of thousands; the indexer's host rate sets the cut), 64
# sampled pages found by their own title token, a round of 32 queries
INDEX_FILES, INDEX_PAGES, INDEX_HOSTS, INDEX_SAMPLED, INDEX_QUERIES = 2, 1000, 500, 64, 32
INDEX_BUILD_KERNELS = ("attention", "add_layernorm", "bias_gelu", "mean_pool", "hll_merge",
                       "hll_estimate")
DEVICE = "cuda"  # the phases run here; a CPU rehearsal of the flow sets "cpu"
# the freshness tier: seeded sites and pages of the fake web (short pages: the
# replicas prepare every page on the host), the share published before the
# crawl starts, the simulated hours crawled, the feed's and front page's
# links, queries a checkpoint, the hours a jump past the TTL drops, the live
# shard of `main.py live-index serve`, the sites the crawl roles crawl; the
# live top 10 against a CPU LiveIndex at rtol / atol 1e-3
LIVE_SEED, LIVE_SITES, LIVE_SITE_PAGES, LIVE_WORDS = 27, 50, 20, (80, 300)
LIVE_BACKLOG, LIVE_HOURS, LIVE_FEED_ITEMS, LIVE_FRONT_LINKS = 0.6, 26, 8, 10
LIVE_QUERIES, LIVE_PRUNED_HOURS, LIVE_CLI_SHARD, LIVE_ROLE_SITES = 64, 3, 7, 5
LIVE_TOL = (1e-3, 1e-3)
# the mesh of shards on the card: its corpus (a segment a shard, 1M pages in
# all), the kernels its serving round must launch, and K9 held against its
# plain version at (shards, K): the serving path's K = 512 (the bucket of the
# pipeline's 300 results) on 4 shards, then K = 1024 on 4 and 8, over a batch
MESH_SHARDS, MESH_DOCS, MESH_SEEDS = 4, 250_000, (1, 2, 3, 4)
MESH_SERVING = ("stage_a", "stage_b_joined", "signals_q16", "mesh_topk")
MESH_TOPK_SHAPES, MESH_TOPK_B = ((4, 512), (4, 1024), (8, 1024)), 16
# the graph roles: the AMPC job's graph (bench_centrality's recipe, cut from the
# centrality phase's 1M nodes: the job's DHT is Python dicts behind sonic RPC,
# one msgpack pair a key), its worker and DHT shards, the approx-harmonic
# samples; the webgraph servers' WARC files (pages a file, hosts, words)
ROLES_NODES, ROLES_EDGES, ROLES_SHARDS, ROLES_DHT, ROLES_SAMPLES = 10_000, 200_000, 4, 2, 4
ROLES_PAGES, ROLES_HOSTS, ROLES_WORDS = 150, 40, (60, 150)
# the pipeline-parallel train step (K16) at MiniLM-L6's width, the ranker it
# exists to scale: a single-head stage for each of its 6 layers, hidden 384,
# FFN 1536, 128 tokens, a (pp, dp) mesh on the card, M microbatches of MB rows
# (split over dp); SGD steps and rate, the steps timed; the kernels it launches
PIPE_S, PIPE_H, PIPE_F, PIPE_T, PIPE_DP, PIPE_M, PIPE_MB = 6, 384, 1536, 128, 2, 8, 16
PIPE_STEPS, PIPE_LR, PIPE_TIMED = 20, 5e-2, 3
PIPE_KERNELS = ("stage_attention", "stage_attention_backward", "gelu_tanh", "sgd")
# K16a-b also held against their plain versions at longer rows and wider
# heads, (T, H) beside the step's (PIPE_T, PIPE_H): where the one-tile forms
# once stopped (512, 1,024), then past 1,024 keys (the key-chunked forms) and
# past H = 1,024
PIPE_WIDE = ((512, PIPE_H), (PIPE_T, 1024), (2048, PIPE_H), (PIPE_T, 1536), (PIPE_T, 2048))
# K4 on LightGBM dumps at production sizes, (trees, leaves): LightGBM's
# default 31 leaves, then 255, each past one block's shared memory (walked in
# chunks of trees); the first is served over HTTP through --lambdamart.
# Rows and features of the kernel check (the forest's 46 signal columns)
LGBM_FORESTS, LGBM_K, LGBM_F = ((500, 31), (1000, 255)), 16384, 46
# K5a and K14a past 512 tokens, (B, T, heads, d): MiniLM's heads at 1,024 and
# 2,048 tokens, and 16,384 tokens of 2 heads of 64, past the length at which
# their chunked kernels' mask and statistics, staged whole, would have left
# a block's 227 KB; K5d at (B, T) of MiniLM's width; train_dual_encoder on
# MiniLM-L6 at LONG_TRAIN_T tokens, batch LONG_TRAIN_B, LONG_TRAIN_STEPS steps
LONG_ATTN = ((8, 1024, 12, 32), (1, 2048, 12, 32), (1, 16384, 2, 64))
LONG_POOL = ((8, 1024), (8, 4096))
LONG_TRAIN_T, LONG_TRAIN_B, LONG_TRAIN_STEPS = 1024, 8, 3

# Tolerances, kernel against plain version on the same card:
#  stage A  scores rtol 1e-5, atol 5e-2: the plain version takes per-doc sums
#           as differences of an f32 cumsum over P*L = 65,536 entries per
#           query (running sums ~1e5), the kernel sums each doc with atomics;
#           docs compared as sets above the C-th score (tie order differs)
#  stage B  scores rtol 1e-5, atol 1e-4 (sums over P <= 64 slots in another
#           order); fused signals within one q16 step
#  pass 2   q16 rows within one step, scales rtol 1e-5
#  forest  rtol 1e-6, atol 1e-6 x sum over trees of max |leaf| (same leaves,
#           the tree sum in another order); bit-equal to a tree-order f32 sum
#           of the plain walk's leaves (the reference's order, the kernel's)
#  attention, LN, GELU  bf16 outputs within one bf16 step (rtol 2^-7) plus
#           atol 1e-2: f32 sums in another order, exp / rsqrt / tanh in
#           another implementation, each may move a value across a rounding
#           boundary of the bf16 cast
#  backward kernels, pool  within one bf16 step of the plain version's
#           largest magnitude (rtol 2^-7, atol 2^-7 x max |plain|): the same
#           reasons, on intermediate roundings (probabilities, dP, each step of
#           the GELU chain); LN parameter gradients (f32 column sums over 8,192
#           rows) rtol 1e-4, atol 1e-4 x max |plain|
#  adamw    rtol 1e-6, atol 1e-6 x max |plain| after 3 steps (the same f32 ops;
#           division and square root may round differently by an ulp)
#  K6a, K7  registers and distances bit-equal (max and min are exact); K6b
#           sizes rel 1e-6 (the 64 powers of two of a row summed in another
#           order); whole HyperBall centrality rtol 1e-6 with the same rounds
#  K8      rows bit-equal (max is exact and order-free), the last step's
#           sizes rel 1e-6 (as K6b); the mesh's HyperBall: every round's
#           registers bit-equal to K6a's, the same rounds, centrality rtol
#           1e-5, atol 1e-9 (expected equal: the same rows through the same
#           estimate and the same f64 sums)
#  K9      docs, shards and scores bit-equal (a selection: no arithmetic);
#           the mesh's pass 1 against the per-segment path: scores rtol 1e-5
#           (stage B's sums over the slots, joined on the card or on the
#           host), docs equal up to ties
#  K1 on q8 rows, K1 with UB  as stage A (UB adds (contrib - ub) + U per
#           entry and takes n*U back out: the same sums, in slot order)
#  K1 over full-length slots (E = P*L, the global table), alone and as one
#           query among sampled ones (two launches)  as stage A against
#           the plain version summing in f64 (plain64): its f32 cumsum over
#           65,536 live entries a query rounds past atol; two calls of every
#           K1 form give bit-equal scores (one add a doc a slot, in slot
#           order) and docs (ties to the lower doc)
#  K11 alone  bit-equal (integer work), and equal to the host join on q16 rows
#  joined stage B  as stage B, and bit-equal to K2 over the host join (the
#           same factors through the same kernel); joined pass 2  as pass 2,
#           and bit-equal to K3 over the host join, q16 and f32 rows
#  K12     f32 rows rtol 1e-5, atol 1e-5 (sums over P slots in another order)
#  K10     scores rtol 1e-6, atol 2e-6 (a 384-term dot product summed by a
#           warp in another order, times the weight, added to base scores of
#           ~10); indices compared as sets above the k-th score
#  K13     the network's keys and payloads bit-equal (a fixed list of
#           compare-exchanges on bit-equal inputs); scores as stage A (the
#           plain version's run sums are f32 cumsum differences, the kernel's
#           direct sums of each run), compared as multisets of (doc, score)
#           above the C-th score: a doc may stand in several runs
#  K15a    probabilities rtol 1e-5 (f32 sums over H in another order, expf),
#           the expert chosen equal where the top two probabilities differ by
#           more than 1e-5, gate and dx within one bf16 step, the router's
#           weight and bias gradients rtol 1e-5, atol 1e-6 x max |plain| (f32
#           sums over the N tokens in another order); two calls of the
#           backward bit-equal (fixed-order sums, no atomics)
#  K15b    forward and the experts' cotangent bit-equal; the gate's cotangent
#           (an f32 row sum in another order, rounded to bf16) one bf16 step
#  K15c    rtol 1e-5, atol 1e-7 (sums over B in another order, exp and log in
#           another implementation); two calls bit-equal (fixed-order sums)
#  K15d    one bf16 step after 3 steps (every operation rounds to bf16;
#           Triton's division and square root are not correctly rounded in
#           f32, which may move a value across a bf16 rounding boundary)
#  K16a-b  rtol 1e-5, atol 1e-5 x max |plain| (f32 sums of T or H terms in
#           another order; the backward held to autograd of the plain forward)
#  K16c    rtol 1e-5, atol 1e-6 x max |x| (tanh through exp: 1 + tanh loses
#           the same bits near -1 in both)
#  K16d    bit-equal after 3 steps (one launch over the 25 tensors; the
#           kernel rounds lr g before the difference, __fmul_rn then
#           __fsub_rn, as the plain version does)
#  pipeline  the pipelined forward against reference_forward through the
#           plain versions at the JAX test's rtol 2e-4, atol 2e-5; the 20-step
#           loss curve through the kernels within 1e-3 per step of the plain
#           versions' (the same f32 ops, sums in other orders, through SGD)
#  MoE     the 20-step loss curve through the kernels within 5 % per step of
#           the plain versions': one-step differences within a bf16 step grow
#           through AdamW, whose first updates are ~lr x sign(g)
A_TOL, B_TOL = (1e-5, 5e-2), (1e-5, 1e-4)
MESH_TOL = 1e-5
P12_TOL, RERANK_TOL = (1e-5, 1e-5), (1e-6, 2e-6)
MOE_CURVE_RTOL = 0.05
PIPE_TOL, PIPE_CURVE_RTOL = (2e-4, 2e-5), 1e-3
# top-10 pages of a configuration against the default's, scores within rtol
# 1e-3: the q16 device join must give all of the default's pages (its stage B is
# held to the host-joined stage B bit for bit in the kernel phase; the page's
# scores are read back from q16 signal rows, the default's from stage B's fused
# rows scaled over 64 columns and the join's from pass 2 scaled over the page, so
# they differ by the q16 steps); the other configurations are printed, not gated
PAGE_RTOL = 1e-3
ENC_TOL = (2 ** -7, 1e-2)
STEP = 2 ** -7
# K14b's widths: MiniLM's (the main row), BertConfig.tiny's and BERT-base's
LN_WIDTHS = (384, 64, 768)
# K5b held against its plain version at these widths (LN_WIDTHS and 1,000,
# off the 8-byte pieces' grid) and rows (ENC_B x ENC_T, the main row, first)
LN_FWD_WIDTHS, LN_FWD_ROWS = LN_WIDTHS + (1000,), (4096, 0, 1, 4099)
# K5d held against its plain version at these batch rows and tokens (the
# dual step's, the main row, first), normalised and not
POOL_B, POOL_T = (64, 1, 256), (128, 1, 17, 512)
# model signals, kernels against plain versions on one card: embedding
# similarities within 2e-2, cross-encoder sigmoids within 1e-2; page scores
# within 5e-3 + 1e-3 relative (0.01 and 0.17 are those signals' weights)
MODEL_TOL = {"title_embedding_similarity": 2e-2, "keyword_embedding_similarity": 2e-2,
             "cross_encoder_snippet": 1e-2, "cross_encoder_title": 1e-2}
PIPE_SCORE_TOL = (1e-3, 5e-3)
TOL_TEXT = {"stage_a": f"rtol {A_TOL[0]} atol {A_TOL[1]}",
            "stage_b": f"rtol {B_TOL[0]} atol {B_TOL[1]}",
            "signals_q16": "1 q16 step, scales rtol 1e-5",
            "stage_a_q8": f"rtol {A_TOL[0]} atol {A_TOL[1]}",
            "stage_a_ub": f"rtol {A_TOL[0]} atol {A_TOL[1]}",
            "stage_a_ub_q8": f"rtol {A_TOL[0]} atol {A_TOL[1]}",
            "factors_join": "bit-equal",
            "stage_b_joined": f"rtol {B_TOL[0]} atol {B_TOL[1]}; bit-equal to K2 over the "
                              "host join",
            "signals_joined": "1 q16 step, scales rtol 1e-5; bit-equal to K3 over the host "
                              "join",
            "signals_prefix": f"rtol {P12_TOL[0]} atol {P12_TOL[1]}",
            "dense_rerank": f"rtol {RERANK_TOL[0]} atol {RERANK_TOL[1]}",
            "forest": "rtol 1e-6 atol 1e-6*sum|leaf|; bit-equal to the tree-order f32 sum",
            "attention": f"rtol 2^-7 atol {2 * ENC_TOL[1]}",
            "add_layernorm": "1 bf16 step (beyond 2^-16*max|plain|); two calls bit-equal",
            "bias_gelu": f"rtol 2^-7 atol {ENC_TOL[1]}",
            "mean_pool": "rtol 2^-7 atol 2^-7*max|plain|; two calls bit-equal",
            "attention_backward": "rtol 2^-7 atol 2^-7*max|plain|",
            "add_layernorm_backward": "rtol 2^-7 atol 2^-7*max|plain|; dw, db rtol 1e-4",
            "bias_gelu_backward": "rtol 2^-7 atol 2^-7*max|plain|; two calls bit-equal",
            "adamw": "rtol 1e-6 atol 1e-6*max|plain|",
            "stage_a_merge": f"network bit-equal; rtol {A_TOL[0]} atol {A_TOL[1]}",
            "moe_router": "probs rtol 1e-5; gate, dx 1 bf16 step; dw, db rtol 1e-5; "
                          "two calls bit-equal",
            "moe_select": "bit-equal; d gate 1 bf16 step",
            "pair_loss": "rtol 1e-5 atol 1e-7; two calls bit-equal",
            "info_nce": "rtol 1e-5 atol 1e-7; two calls bit-equal",
            "adamw_bf16": "1 bf16 step after 3 steps",
            "hll_merge": "registers and change bytes bit-equal, sizes rel 1e-6",
            "hll_estimate": "rel 1e-6", "bfs_relax": "bit-equal",
            "mesh_topk": "bit-equal",
            "hll_ring_step": "rows and change bytes bit-equal, sizes rel 1e-6",
            "stage_attention": "rtol 1e-5 atol 1e-5*max|plain|",
            "stage_attention_backward": "rtol 1e-5 atol 1e-5*max|plain| (vs autograd)",
            "gelu_tanh": "rtol 1e-5 atol 1e-6*max|x|", "sgd": "bit-equal"}


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def topk_match(docs_a, scores_a, docs_b, scores_b, num_docs, rtol, atol) -> float:
    """Raise unless two top-k lists agree (sorted scores within tolerance;
    every doc clearly above the k-th score in both); → max |score diff|."""
    import numpy as np

    fa, fb = np.isfinite(scores_a), np.isfinite(scores_b)
    if fa.sum() != fb.sum():
        raise AssertionError(f"finite counts differ: {fa.sum()} vs {fb.sum()}")
    if not ((docs_a[~fa] == num_docs).all() and (docs_b[~fb] == num_docs).all()):
        raise AssertionError("pad entries must carry the pad doc")
    sa, sb = np.sort(scores_a[fa])[::-1], np.sort(scores_b[fb])[::-1]
    err = float(np.max(np.abs(sa - sb))) if len(sa) else 0.0
    np.testing.assert_allclose(sb, sa, rtol=rtol, atol=atol)
    if len(sa):
        cut = sa[-1] + 2 * (abs(sa[-1]) * rtol + atol) if fa.all() else -np.inf
        mb = dict(zip(docs_b[fb].tolist(), scores_b[fb].tolist()))
        for d, s in zip(docs_a[fa].tolist(), scores_a[fa].tolist()):
            if s > cut:
                if d not in mb:
                    raise AssertionError(f"doc {d} (score {s}) missing")
                err = max(err, abs(mb[d] - s))
                np.testing.assert_allclose(mb[d], s, rtol=rtol, atol=atol)
    return err


def rerank_match(got, want) -> float:
    """K10's (indices, scores) [B, k] against its plain version's: scores
    within RERANK_TOL, indices equal except where the plain score ties with
    another within that tolerance; → max |score diff|."""
    import numpy as np

    (i_k, s_k), (i_p, s_p) = ([t.cpu().numpy() for t in x] for x in (got, want))
    np.testing.assert_allclose(s_k, s_p, rtol=RERANK_TOL[0], atol=RERANK_TOL[1])
    for b, pos in zip(*np.nonzero(i_k != i_p)):
        near = np.abs(s_p[b] - s_p[b, pos]) <= RERANK_TOL[1] + RERANK_TOL[0] * abs(s_p[b, pos])
        if near.sum() < 2:
            raise AssertionError(f"K10's index {i_k[b, pos]} at query {b}, place {pos}: the "
                                 f"plain version has {i_p[b, pos]}, no tie")
    return float(np.abs(s_k - s_p).max())


def topk_runs_match(docs_a, scores_a, docs_b, scores_b, num_docs, rtol, atol) -> float:
    """topk_match for results in which a doc may stand several times (stage
    A under the merge): sorted scores within tolerance, and every entry
    clearly above the k-th score matched by an entry of the same doc with its
    score, each used once; → max |score diff|."""
    import numpy as np

    fa, fb = np.isfinite(scores_a), np.isfinite(scores_b)
    if fa.sum() != fb.sum():
        raise AssertionError(f"finite counts differ: {fa.sum()} vs {fb.sum()}")
    if not ((docs_a[~fa] == num_docs).all() and (docs_b[~fb] == num_docs).all()):
        raise AssertionError("pad entries must carry the pad doc")
    sa, sb = np.sort(scores_a[fa])[::-1], np.sort(scores_b[fb])[::-1]
    err = float(np.max(np.abs(sa - sb))) if len(sa) else 0.0
    np.testing.assert_allclose(sb, sa, rtol=rtol, atol=atol)
    cut = sa[-1] + 2 * (abs(sa[-1]) * rtol + atol) if len(sa) and fa.all() else -np.inf
    left: dict = {}
    for d, x in zip(docs_b[fb].tolist(), scores_b[fb].tolist()):
        left.setdefault(d, []).append(x)
    for d, x in zip(docs_a[fa].tolist(), scores_a[fa].tolist()):
        if x <= cut:
            continue
        near = [y for y in left.get(d, []) if abs(y - x) <= atol + rtol * abs(x)]
        if not near:
            raise AssertionError(f"doc {d} (score {x}) missing")
        best = min(near, key=lambda y: abs(y - x))
        left[d].remove(best)
        err = max(err, abs(best - x))
    return err


def time_ms(fn, iters: int = 10) -> float:
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def time_reset_ms(fn, reset, iters: int = 10) -> float:
    """time_ms for a call that changes its own input: reset() before each
    call, outside the call's pair of CUDA events (each call timed alone)."""
    import torch

    for _ in range(2):
        reset()
        fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(iters)]
    for a, b in pairs:
        reset()
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def search_rows(lens, n: int, steps=None, cap=None) -> int:
    """The distinct posting rows that n binary searches over each slot of
    `lens` rows can touch, summed over the slots: step d of a search has at
    most min(2^d, n) different midpoints (the searches of one slot share their
    upper levels), and a slot gives no more rows than it holds (or than `cap`).
    `steps` is the fixed step count of the prefix search; else a slot of len
    rows takes ceil(log2(len + 1)) steps."""
    import numpy as np

    lens = np.asarray(lens, dtype=np.int64)
    held = lens if cap is None else np.minimum(lens, cap)
    depth = (np.ceil(np.log2(held + 1)).astype(np.int64) if steps is None
             else np.where(held > 0, steps, 0))
    rows = np.zeros_like(held)
    for d in range(int(depth.max(initial=0))):
        rows += np.where(d < depth, min(1 << d, n), 0)
    return int(np.minimum(rows, held).sum())


def pad_slots(q, P: int):
    """Query slots padded with empty optional slots to P."""
    import numpy as np

    from stract_tpu_torch.ops import scoring as O

    n = q.starts.shape[0]
    if n > P:
        raise ValueError(f"{n} slots do not fit {P}")
    return q._replace(**{f: np.pad(getattr(q, f), (0, P - n),
                                   constant_values=O.OPTIONAL_GROUP if f == "group" else 0)
                         for f in ("starts", "lens", "group", "idf", "w_bm25", "w_bm25f",
                                   "w_presence")})


def compacted_slots(slots: list) -> tuple:
    """Stage B's view of sampled queries: each (slots, aggregates) pair
    compacted (empty slots dropped) and padded to the batch's one slot count
    → (pairs, that count)."""
    import numpy as np

    from stract_tpu_torch.index.inverted import InvertedIndex

    comp = [InvertedIndex._compact_slots(q, a, min_p=16) for q, a in slots]
    Pc = max(q.starts.shape[0] for q, _ in comp)
    return [(pad_slots(q, Pc),
             a._replace(**{f: np.pad(getattr(a, f), ((0, 0), (0, Pc - q.starts.shape[0])))
                           for f in a._fields})) for q, a in comp], Pc


def full_slots(seg, q, rng):
    """The batch q (numpy QuerySlots, P slots) with every slot a distinct
    posting list of at least L rows of the segment, drawn by rng, each
    query's weights those of its first slot, its first slot's group required,
    the rest optional: E = P*L entries, K1's global table."""
    import numpy as np

    from stract_tpu_torch.ops import scoring as O

    long_terms = np.nonzero(np.asarray(seg.term_lens) >= L)[0]
    B, P = q.starts.shape
    terms = np.stack([rng.choice(long_terms, P, replace=False) for _ in range(B)])
    first = lambda x: np.repeat(np.asarray(x)[:, :1], P, axis=1)  # noqa: E731
    group = np.full((B, P), O.OPTIONAL_GROUP, np.int32)
    group[:, 0] = 0
    return q._replace(starts=np.asarray(seg.term_starts)[terms].astype(np.int32),
                      lens=np.asarray(seg.term_lens)[terms].astype(np.int32), group=group,
                      n_required=np.ones(B, np.int32), idf=first(q.idf), w_bm25=first(q.w_bm25),
                      w_bm25f=first(q.w_bm25f), w_presence=first(q.w_presence))


def crossing_slots(seg, q):
    """The batch q (numpy QuerySlots, P doc-ordered slots) with its first
    query's slots all windows of L rows of one list of at least L + 2, started
    0, 1 or 2 rows in, with that query's first slot's weights: the merge
    leaves its docs ascending, each in a run of up to P entries, and at P =
    64 a run crosses every tile boundary of the global form."""
    import numpy as np

    term = int(np.nonzero(np.asarray(seg.term_lens) >= L + 2)[0][0])
    P = q.starts.shape[1]
    fields = {f: np.array(getattr(q, f)) for f in ("starts", "lens", "idf", "w_bm25",
                                                    "w_bm25f", "w_presence")}
    fields["starts"][0] = int(np.asarray(seg.term_starts)[term]) + np.arange(P) % 3
    fields["lens"][0] = L
    for f in ("idf", "w_bm25", "w_bm25f", "w_presence"):
        fields[f][0] = fields[f][0, 0]
    return q._replace(**fields)


def join_cases(seg, arrays, qc_np, ac, cand) -> None:
    """K11 over B queries' compacted slots with their first three queries'
    slots reset to cross the join plan's length threshold: an empty slot, a
    one-row slot, the last posting list, the last 100 rows of the card's
    array (pad rows: a range that ends at its last row), a list's first
    `sample` rows (staged whole) and first sample + 1 (searched from a
    sample), and the
    candidates with duplicates, pad docs and the boundary rows' docs. On
    q16 and q8 rows the join must equal the plain join; on q16 rows joined
    stage B must equal K2 over that join, and joined pass 2 at K = 512 K3
    over it, bit for bit."""
    import numpy as np
    import torch

    from stract_tpu_torch.ops import kernels
    from stract_tpu_torch.ops import scoring as O

    term_starts = np.asarray(seg.term_starts, dtype=np.int64)
    term_lens = np.asarray(seg.term_lens, dtype=np.int64)
    n_rows = int(arrays[0].postings.shape[0])
    plan = kernels.join_plan(KD)
    last = int(np.argmax(term_starts + term_lens))
    n_post = int(term_starts[last] + term_lens[last])
    long_t = int(np.nonzero(term_lens > plan.sample + 1)[0][0])
    st, ln = np.array(qc_np.starts), np.array(qc_np.lens)
    st[0, :2], ln[0, :2] = term_starts[long_t], (0, 1)
    st[1, :2], ln[1, :2] = (term_starts[last], n_rows - 100), (term_lens[last], 100)
    st[2, :2], ln[2, :2] = term_starts[long_t], (plan.sample, plan.sample + 1)
    q_np = qc_np._replace(starts=st.astype(np.int32), lens=ln.astype(np.int32))
    c = cand.clone()
    post = arrays[0].postings
    c[:, 7], c[:, 11] = c[:, 3], int(seg.num_docs)
    c[0, 13] = post[int(term_starts[long_t]), 0]           # the one-row slot's doc
    c[1, 13] = post[n_post - 1, 0]                         # the last posting's doc
    c[2, 13] = post[int(term_starts[long_t]) + plan.sample, 0]  # the first sampled row's
    regimes = {kernels.join_regime(int(n), n_rows, plan) for n in ln[:3].ravel()}
    if not {"empty", "whole", "sample"} <= regimes:
        raise AssertionError(f"the crossing batch takes the regimes {regimes}")
    q_t = O.to_tensors(q_np, DEVICE)
    for rows in arrays:
        f_k = O.factors_join(rows, q_t.starts, q_t.lens, c)
        f_p = O.factors_join_plain(rows.postings, q_t.starts, q_t.lens, c)
        if not torch.equal(f_k, f_p):
            raise AssertionError("K11 differs from the plain join on the crossing batch")
    f_p = O.factors_join_plain(arrays[0].postings, q_t.starts, q_t.lens, c)
    d_k, s_k = O.score_driver_joined_batch(arrays[0], q_t, c, True, OUT_K)
    d_2, s_2 = O.score_driver_batch(arrays[0], q_t, f_p, c, True, OUT_K)
    pg = c[:, :512].contiguous()
    (q_j, sc_j), (q_3, sc_3) = (O.compute_signals_joined_batch_q16(arrays[0], q_t, ac, pg),
                                O.compute_signals_from_factors_batch_q16(
                                    arrays[0], q_t, ac, f_p[:, :, :512].contiguous(), pg))
    if not (torch.equal(d_k, d_2) and torch.equal(s_k.view(torch.int32), s_2.view(torch.int32))
            and torch.equal(q_j, q_3) and torch.equal(sc_j.view(torch.int32),
                                                      sc_3.view(torch.int32))):
        raise AssertionError("joined stage B or pass 2 differs from K2 / K3 over the join on the "
                             "crossing batch")
    log(f"[config kernels] K11 on the crossing batch (regimes {sorted(regimes)}, {plan}): "
        f"bit-equal to the plain join on q16 and q8 rows; joined stage B and "
        f"pass 2 bit-equal to K2 and K3 over it")


def plain64(arrays, q, device) -> tuple:
    """The segment's arrays and the numpy slots q for K1's plain version in
    f64 (the static columns and the slots' weights; the plain version then
    sums in f64): with full-length slots its f32 cumsum runs over 65,536 live
    entries a query, whose rounding (a few ulps of running sums ~1e5-1e6)
    passes stage A's atol; the kernel's per-doc f32 sums round once a slot.
    → (arrays, slots) on `device`."""
    import numpy as np
    import torch

    from stract_tpu_torch.ops import scoring as O

    q64 = O.QuerySlots(*[torch.as_tensor(np.asarray(x), device=device, dtype=torch.int32
                                         if f in ("starts", "lens", "group", "n_required")
                                         else torch.float64) for f, x in zip(q._fields, q)])
    return arrays._replace(static_cols=arrays.static_cols.double()), q64


def kernel_phase(index, device) -> list:
    """K1, K2, K3 against their plain versions on real slots of sampled
    queries, for both static modes; K1 and K2 also timed as the index calls
    them, with numpy slots (their upload in the call), and K1 in each table
    form: the sampled slots (the main path's), a shallow scan of them (L =
    64: one block a query), 64 full-length slots a query (E = P*L: the
    global table), and one such query among the sampled ones (two
    launches), each against its plain version and a second call bit-equal.
    → rows per (kernel, default_static)."""
    import numpy as np
    import torch

    from stract_tpu_torch import bench_corpus as bc
    from stract_tpu_torch.index.inverted import InvertedIndex
    from stract_tpu_torch.ops import kernels
    from stract_tpu_torch.ops import scoring as O
    from stract_tpu_torch.ranking.computer import QueryContext, build_slots

    seg = index.segments[0]
    dev = index.device_segment_for(seg)
    nd = seg.num_docs
    T = lambda x, dt=torch.int32: torch.as_tensor(x, dtype=dt).to(device)  # noqa: E731
    queries = bc.sample_queries(np.random.default_rng(SEED), B)
    rows = []
    for ds in (True, False):
        ctxs = [QueryContext(raw=q, simple_terms=q.split(), current_ts=NOW,
                             coefficients={} if ds else CUSTOM) for q in queries]
        slots = [build_slots(c, seg, index.num_docs, index.region_scores()) for c in ctxs]
        P = max(q.starts.shape[0] for q, _ in slots)
        if any(q.starts.shape[0] != P for q, _ in slots):
            raise AssertionError("sampled queries must share one slot bucket")
        qa_np = O.stack([InvertedIndex._augment_with_impact(seg, dev, q)[0] for q, _ in slots])

        # K1: stage A, in each table form (the main path's first)
        full = full_slots(seg, qa_np, np.random.default_rng(SEED))
        mixed = O.QuerySlots(*[np.concatenate([np.asarray(f)[:1], np.asarray(a)[1:]])
                               for f, a in zip(full, qa_np)])  # a full query among sampled
        forms = (("main", qa_np, L), ("shallow", qa_np, 64), ("full", full, L),
                 ("mixed", mixed, L))
        for form, q_np, L_ in forms:
            q_t = O.to_tensors(q_np, device)
            plans = [p for _, p in kernels.stage_a_launches(O.stage_a_entries(q_np.lens, L_), C,
                                                            kernels.card_sms(device))]
            run_k = lambda: O.score_candidates_batch(dev.arrays, q_t, L_, C, ds, True)  # noqa
            run_p = lambda: O.score_candidates_batch_plain(dev.arrays, q_t, L_, C, ds, True)  # noqa
            if form in ("full", "mixed"):  # the plain version's sums in f64 (see plain64)
                seg64, q64 = plain64(dev.arrays, q_np, device)
                check_p = lambda: O.score_candidates_batch_plain(  # noqa: E731
                    seg64, q64, L_, C, ds, True)
            else:
                check_p = run_p
            (d_k, s_k), (d_2, s_2) = run_k(), run_k()
            if not (torch.equal(s_k.view(torch.int32), s_2.view(torch.int32))
                    and torch.equal(d_k, d_2)):
                raise AssertionError(f"two stage-A calls differ ({form} slots, {plans})")
            d_k, s_k = d_k.cpu().numpy(), s_k.cpu().numpy()
            d_p, s_p = [x.cpu().numpy() for x in check_p()]
            err = max(topk_match(d_p[b], s_p[b], d_k[b], s_k[b], nd, *A_TOL) for b in range(B))
            if not np.isfinite(s_k).any():
                raise AssertionError("stage A found no candidates")
            scanned = int(q_t.lens.clamp(max=L_).sum())  # posting rows of the slots' prefixes
            shape = (C, *[f"{p.form} E={p.entries} T={p.slots} x{p.cluster}" for p in plans],
                     f"L={L_}")
            rows.append(("stage_a", ds, err, time_ms(run_k), time_ms(run_p), shape,
                         12 * scanned + sum(x.numel() * 4 for x in q_t) + 8 * B * C,
                         10 * scanned))
            if form == "main":
                main_ms = time_ms(lambda: O.score_candidates_batch(dev.arrays, qa_np, L, C, ds,
                                                                   True))
                log(f"[kernels] K1 default_static={ds} {plans}: {rows[-1][3]:.4f} ms with the "
                    f"slots on the card, {main_ms:.4f} ms as the index calls it (numpy slots "
                    f"uploaded in the call)")
                cand = d_k
        d_k = cand

        # K2: stage B over stage A's candidates, fused signals
        comp, Pc = compacted_slots(slots)
        facs = np.zeros((B, Pc, KD), np.int32)
        for j, (q, _) in enumerate(comp):
            InvertedIndex._slot_factors_for(seg, q, d_k[j], out=facs[j])
        qc = O.to_tensors(O.stack([q for q, _ in comp]), device)
        ac = O.to_tensors(O.stack([a for _, a in comp]), device)
        f_t, c_t = T(facs), T(d_k)
        run_k = lambda: O.score_driver_batch_with_signals(  # noqa: E731
            dev.arrays, qc, f_t, c_t, ac, ds, OUT_K, SIG_K)
        qc_np, ac_np = O.stack([q for q, _ in comp]), O.stack([a for _, a in comp])
        main_ms = time_ms(lambda: O.score_driver_batch_with_signals(
            dev.arrays, qc_np, facs, d_k, ac_np, ds, OUT_K, SIG_K))
        log(f"[kernels] K2 default_static={ds} Kd={KD} k={OUT_K} ks={SIG_K} P={Pc} over "
            f"{kernels.stage_b_cluster(KD)} blocks a query: {time_ms(run_k):.4f} ms with the "
            f"inputs on the card, {main_ms:.4f} ms as the index calls it (numpy slots, "
            f"candidates and {facs.nbytes} B of factors uploaded in the call)")
        run_p = lambda: O.score_driver_batch_plain(  # noqa: E731
            dev.arrays, qc, f_t, c_t, ds, OUT_K, ac, SIG_K)
        dk, sk, sigk = O.unpack_stageb(run_k(), OUT_K, 46, SIG_K)
        res_p = run_p()
        dp, sp, sigp = O.unpack_stageb(res_p, OUT_K, 46, SIG_K)
        scale = res_p[3].cpu().numpy()
        err = 0.0
        for b in range(B):
            err = max(err, topk_match(dp[b], sp[b], dk[b], sk[b], nd, *B_TOL))
            col = {int(d): i for i, d in enumerate(dp[b][:SIG_K]) if d < nd}
            for i, d in enumerate(dk[b][:SIG_K]):
                if d < nd and int(d) in col:
                    diff = np.abs(sigk[b][:, i] - sigp[b][:, col[int(d)]])
                    if (diff > 1.001 * scale[b] + 1e-30).any():
                        raise AssertionError(f"stage-B signals differ by {diff.max()}")
                    err = max(err, float(diff.max()))
        rows.append(("stage_b", ds, err, time_ms(run_k), time_ms(run_p), KD,
                     4 * (f_t.numel() + c_t.numel()) + sum(x.numel() * 4 for x in (*qc, *ac))
                     + 8 * B * OUT_K + 2 * B * 46 * SIG_K, 10 * f_t.numel()))

        # K3: pass 2 over a page of stage B's winners, and over a 300-row
        # recall block (the pipeline's K=512 bucket); also over one column
        # and over all 4,096 of stage A's candidates (its shape's two ends)
        for page_k in PASS2_K:
            page = (dk[:, :page_k] if page_k <= OUT_K else d_k[:, :page_k]).astype(np.int32)
            pf = np.zeros((B, Pc, page_k), np.int32)
            for j, (q, _) in enumerate(comp):
                InvertedIndex._slot_factors_for(seg, q, page[j], out=pf[j])
            pf_t, pg_t = T(pf), T(page)
            run_k = lambda: O.compute_signals_from_factors_batch_q16(  # noqa: E731
                dev.arrays, qc, ac, pf_t, pg_t)
            run_p = lambda: O.compute_signals_from_factors_batch_q16_plain(  # noqa: E731
                dev.arrays, qc, ac, pf_t, pg_t)
            qk, sck = run_k()
            qp, scp = run_p()
            torch.testing.assert_close(sck, scp, rtol=1e-5, atol=1e-35)
            step = int((qk.int() - qp.int()).abs().max().item())
            if step > 1:
                raise AssertionError(f"pass-2 q16 rows differ by {step} steps")
            err = float(np.abs(O.dequantize_signals(qk, sck)
                               - O.dequantize_signals(qp, scp)).max())
            rows.append(("signals_q16", ds, err, time_ms(run_k), time_ms(run_p), page_k,
                         4 * (pf_t.numel() + pg_t.numel()) + sum(x.numel() * 4 for x in
                                                                 (*qc, *ac))
                         + 2 * B * 46 * page_k + 4 * B * 46, 2 * 46 * pf_t.numel()))
    return rows


def requests_mix(n: int) -> list:
    """Generated search bodies: 2-term AND queries (driver and scan mode),
    a three-term query, custom coefficients, an exclusion, deep pages (their
    page signals miss the fused stage-B rows and run pass 2)."""
    import numpy as np

    from stract_tpu_torch import bench_corpus as bc

    rng = np.random.default_rng(SEED + 1)
    qs = bc.sample_queries(rng, n)
    out = []
    for i, q in enumerate(qs):
        body = {"query": q}
        kind = i % 8
        if kind == 1:
            body["query"] = f"w{i % 5} w{5 + i % 7}"  # two head terms: the scan path
        elif kind == 2:
            body["query"] = f"{q} w{int(rng.integers(0, 50))}"
        elif kind == 3:
            body["signalCoefficients"] = CUSTOM
        elif kind == 4:
            body["query"] = f"{q} -w{int(rng.integers(50, 100))}"
        elif kind == 5:
            body.update(page=4, numResults=20)
        elif kind == 6:
            body["returnRankingSignals"] = True
        out.append(body)
    return out


def post(url: str, body: dict):
    req = urllib.request.Request(url, data=json.dumps(body).encode(), method="POST",
                                 headers={"content-type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=300) as resp:
        status, data = resp.status, json.loads(resp.read())
    return status, data, time.perf_counter() - t0


@contextlib.contextmanager
def plain_versions():
    """Route the device programs to their plain PyTorch versions on the same
    card (the reference run of the comparisons): K1-K3 in ops/scoring.py, K4
    in ops/forest.py, K5a-d and their gradients K14a-c in ops/encoder.py (the
    dispatchers the autograd Functions call), K14d and K15d in optim.py,
    K15a-b in ops/moe.py, K15c in ops/losses.py, K6a-b in ops/hll_ops.py (K6a's
    systolic round by its twin merge_systolic_plain),
    K7 in webgraph/shortest_path.py (over the edges of the reverse CSR the
    kernels take) and K16a-d in ops/stage.py. Stage A keeps its
    configuration's arguments (UB bounds, the merge)."""
    import torch

    from stract_tpu_torch import optim
    from stract_tpu_torch.ops import encoder as E
    from stract_tpu_torch.ops import forest as FO
    from stract_tpu_torch.ops import hll_ops as HO
    from stract_tpu_torch.ops import losses as LO
    from stract_tpu_torch.ops import moe as MO
    from stract_tpu_torch.ops import scoring as O
    from stract_tpu_torch.ops import stage as ST
    from stract_tpu_torch.webgraph import shortest_path as SP

    def stage_a(seg, qs, L, K, ds, soft_required=False, ub_entry=None, ub_total=None,
                merge=False):
        dev = seg.postings.device
        qs = O.to_tensors(O._batched(qs, O.QuerySlots), dev)
        return O.score_candidates_batch_plain(seg, qs, L, K, ds, soft_required,
                                              O._on(ub_entry, dev, torch.float32),
                                              O._on(ub_total, dev, torch.float32), merge)

    def stage_b(seg, qs, f, d, aggs, ds, out_k, sig_k):
        dev = seg.postings.device
        return O.score_driver_batch_plain(
            seg, O.to_tensors(O._batched(qs, O.QuerySlots), dev),
            torch.as_tensor(f).to(dev), torch.as_tensor(d).to(dev), ds, out_k,
            O.to_tensors(O._batched(aggs, O.QueryAggregates), dev), sig_k)

    def signals(seg, qs, aggs, f, c):
        dev = seg.postings.device
        return O.compute_signals_from_factors_batch_q16_plain(
            seg, O.to_tensors(O._batched(qs, O.QuerySlots), dev),
            O.to_tensors(O._batched(aggs, O.QueryAggregates), dev),
            torch.as_tensor(f).to(dev), torch.as_tensor(c).to(dev))

    def hll_merge(regs, csr, out=None, sizes=True, flags=None, flags_out=None):
        new, rows = HO.merge_systolic_plain(regs, flags, csr.sources, SP.csr_targets(csr))
        if flags_out is not None:
            flags_out.copy_(rows)
        changed = rows.any().to(torch.int32).reshape(1)
        return new, HO.estimate_sizes_plain(new) if sizes else None, changed

    def bfs_step(state, csr, level, out=None):
        return SP.frontier_step_plain(state, csr.sources, SP.csr_targets(csr), level)

    swaps = [(O, "score_candidates_batch", stage_a),
             (O, "score_driver_batch_with_signals", stage_b),
             (O, "compute_signals_from_factors_batch_q16", signals),
             (FO, "gbdt_forward", FO.gbdt_forward_plain),
             (E, "attention_forward", E.attention_plain),
             (E, "add_layernorm_forward", E.add_layernorm_plain),
             (E, "bias_gelu_forward", E.bias_gelu_plain),
             (E, "mean_pool_forward", E.mean_pool_plain),
             (E, "attention_backward", E.attention_backward_plain),
             (E, "add_layernorm_backward", E.add_layernorm_backward_plain),
             (E, "bias_gelu_backward", E.bias_gelu_backward_plain),
             (E, "mean_pool_backward", E.mean_pool_backward_plain),
             (optim, "adamw_update", optim.adamw_update_plain),
             (optim, "adamw_bf16_update", optim.adamw_bf16_update_plain),
             (MO, "router_forward", MO.router_plain),
             (MO, "router_backward", MO.router_backward_plain),
             (MO, "select_scale_forward", MO.select_scale_plain),
             (MO, "select_scale_backward", MO.select_scale_backward_plain),
             (LO, "pair_loss_forward", LO.pair_loss_plain),
             (LO, "info_nce_forward", LO.info_nce_plain),
             (HO, "merge_csr", hll_merge), (HO, "estimate_sizes", HO.estimate_sizes_plain),
             (SP, "frontier_step", bfs_step),
             (ST, "stage_attention_forward", ST.stage_attention_plain),
             (ST, "stage_attention_backward", ST.stage_attention_backward_plain),
             (ST, "gelu_tanh_forward", ST.gelu_tanh_plain),
             (ST, "gelu_tanh_backward", ST.gelu_tanh_backward_plain),
             (ST, "sgd_update_many", ST.sgd_update_many_plain)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def serve_phase(searcher, expect, rounds: int = 1, bodies=None) -> dict:
    """HTTP traffic through the in-process server, `rounds` rounds of the
    request mix (or of `bodies`); counters reset first. Every request must be
    answered, and every kernel named in `expect` launched by that traffic.
    qps is over all rounds; "round_qps" lists each round's."""
    import numpy as np

    from stract_tpu_torch.api.server import build_app
    from stract_tpu_torch.main import ServerThread
    from stract_tpu_torch.ops import kernels

    bodies = bodies or requests_mix(N_REQUESTS)
    server = ServerThread(build_app(searcher, max_concurrency=2 * CLIENTS))
    results, round_qps = [], []
    try:
        post(server.url + "/beta/api/search", {"query": "w1 w2"})  # warm-up, not counted
        kernels.reset_launches()
        t0 = time.perf_counter()
        for _ in range(rounds):
            t1 = time.perf_counter()
            with ThreadPoolExecutor(CLIENTS) as pool:
                results += pool.map(lambda b: post(server.url + "/beta/api/search", b), bodies)
            round_qps.append(len(bodies) / (time.perf_counter() - t1))
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        with urllib.request.urlopen(server.url + "/metrics", timeout=60) as resp:
            metrics = resp.read().decode()
    finally:
        server.stop()
    lat = np.array([r[2] for r in results])
    bad = [(body, status, data) for body, (status, data, _) in zip(bodies * rounds, results)
           if status != 200 or data.get("type") != "websites" or "webpages" not in data]
    if bad:
        body, status, data = bad[0]
        raise AssertionError(f"{len(bad)} bad answers, the first to {body}: {status} "
                             f"{str(data)[:200]}")
    n_hits = sum(len(d["webpages"]) for _, d, _ in results)
    if n_hits == 0:
        raise AssertionError("no request returned a webpage")
    if any(launches[k] == 0 for k in expect):
        raise AssertionError(f"a kernel was not launched by the HTTP traffic: {launches}")
    if f'search_requests_total{{status="ok"}} {len(results) + 1}' not in metrics:
        raise AssertionError("metrics do not count every answered request")
    return {"requests": len(results), "rounds": rounds, "clients": CLIENTS, "wall_s": wall,
            "failed": len(bad), "qps": len(results) / wall, "round_qps": round_qps,
            "p50_ms": float(np.median(lat) * 1e3),
            "p99_ms": float(np.quantile(lat, 0.99) * 1e3), "webpages": n_hits,
            "launches": launches}


def compare_pipeline_page(pp, pk, forest) -> tuple:
    """Pipeline-on pages, plain (pp) against kernels (pk): model signals
    within MODEL_TOL, others within 1e-3 relative; a row whose two signal
    vectors lie on two sides of a forest split may flip a leaf, so its
    lambda_mart and score are not compared and a page holding one is
    compared on its shared rows only. → (max score diff, flipped rows)."""
    import numpy as np

    from stract_tpu_torch.ranking.models.lambdamart import signal_matrix

    wp, wk = pp["webpages"], pk["webpages"]
    by_url = {w["url"]: i for i, w in enumerate(wp)}
    shared = [(by_url[w["url"]], ik) for ik, w in enumerate(wk) if w["url"] in by_url]
    flips = forest.split_between(signal_matrix([wp[i] for i, _ in shared]),
                                 signal_matrix([wk[i] for _, i in shared]))
    err = 0.0
    for (ip, ik), flip in zip(shared, flips):
        a, b = wk[ik]["rankingSignals"], wp[ip]["rankingSignals"]
        for name in (set(a) | set(b)) - {"lambda_mart"}:
            x, y = a.get(name, 0.0), b.get(name, 0.0)
            if abs(x - y) > MODEL_TOL.get(name, 1e-3 * max(1.0, abs(y))):
                raise AssertionError(f"signal {name} differs: {x} vs {y}")
        if not flip:
            err = max(err, abs(wk[ik]["score"] - wp[ip]["score"]))
            if abs(a.get("lambda_mart", 0.0) - b.get("lambda_mart", 0.0)) > 1e-5 * max(
                    1.0, abs(b.get("lambda_mart", 0.0))):
                raise AssertionError("lambda_mart differs on a row that walks the same leaves")
    if not flips.any():
        if {w["url"] for w in wp} != {w["url"] for w in wk}:
            raise AssertionError("the pages hold other documents")
        ids = {w["url"]: i for i, w in enumerate(wp)}
        err = max(err, topk_match(np.array([ids[w["url"]] for w in wp]),
                                  np.array([w["score"] for w in wp]),
                                  np.array([ids[w["url"]] for w in wk]),
                                  np.array([w["score"] for w in wk]), -1, *PIPE_SCORE_TOL))
    return err, int(flips.sum())


def page_match(wk, wp) -> float:
    """Two pages (kernels, plain versions) hold the same documents with the
    same scores: rtol 1e-3, atol 1e-3, documents tied at the cut as sets. →
    the largest score difference."""
    import numpy as np

    ids = {w["url"]: i for i, w in enumerate(wk + wp)}
    return topk_match(np.array([ids[w["url"]] for w in wp]), np.array([w["score"] for w in wp]),
                      np.array([ids[w["url"]] for w in wk]), np.array([w["score"] for w in wk]),
                      -1, 1e-3, 1e-3)


def compare_phase(searcher, forest=None, bodies=None) -> dict:
    """Top-10 of 8 queries (or of `bodies`): kernels against the plain
    versions, same card. With the pipeline on (`forest` given), pages carry
    their signals and compare through compare_pipeline_page."""
    import numpy as np

    from stract_tpu_torch.searcher.query import SearchQuery

    extra = {"numResults": 10, "returnRankingSignals": forest is not None}
    bodies = bodies or compare_bodies()
    kern = [searcher.search(SearchQuery.from_json({**b, **extra})).to_json() for b in bodies]
    with plain_versions():
        plain = [searcher.search(SearchQuery.from_json({**b, **extra})).to_json()
                 for b in bodies]
    err, n, flipped = 0.0, 0, 0
    for pk, pp in zip(kern, plain):
        wk, wp = pk["webpages"], pp["webpages"]
        if forest is not None:
            e, f = compare_pipeline_page(pp, pk, forest)
            err, flipped = max(err, e), flipped + f
        else:
            err = max(err, page_match(wk, wp))
        n += len(wk)
    if n == 0:
        raise AssertionError("the compared queries returned nothing")
    return {"queries": len(bodies), "docs": n, "max_score_diff": err, "forest_flips": flipped}


@contextlib.contextmanager
def join_timer():
    """Time the host factor join (InvertedIndex._slot_factors_for) while the
    block runs → {"calls", "seconds"}, summed over the server's threads."""
    import threading

    from stract_tpu_torch.index.inverted import InvertedIndex

    real = InvertedIndex.__dict__["_slot_factors_for"]
    acc, lock = {"calls": 0, "seconds": 0.0}, threading.Lock()

    def timed(*a, **kw):
        t0 = time.perf_counter()
        try:
            return real.__func__(*a, **kw)
        finally:
            dt = time.perf_counter() - t0
            with lock:
                acc["calls"] += 1
                acc["seconds"] += dt
    InvertedIndex._slot_factors_for = staticmethod(timed)
    try:
        yield acc
    finally:
        InvertedIndex._slot_factors_for = real


def compare_bodies() -> list:
    return [b for b in requests_mix(64) if "page" not in b][:8]


def top10_pages(searcher) -> list:
    """The top-10 page of each compare query, through the searcher."""
    from stract_tpu_torch.searcher.query import SearchQuery

    return [searcher.search(SearchQuery.from_json({**b, "numResults": 10})).to_json()["webpages"]
            for b in compare_bodies()]


def page_diff(wa, wb, rtol: float):
    """Two top-10 pages hold the same documents with the same scores: a
    document on both has scores within rtol (relative, of at least 1), and a
    document on one page only ties both pages' last scores within rtol (a
    tie at the cut may fall either way). → the largest score difference, or None
    where the pages differ."""
    if len(wa) != len(wb):
        return None
    sa, sb = ({w["url"]: w["score"] for w in page} for page in (wa, wb))
    close = lambda x, y: abs(x - y) <= rtol * max(abs(x), abs(y), 1.0)  # noqa: E731
    for mine, other in ((sa, sb), (sb, sa)):
        if any(not (close(s, min(mine.values())) and close(s, min(other.values())))
               for u, s in mine.items() if u not in other):
            return None
    if any(not close(sa[u], sb[u]) for u in sa.keys() & sb.keys()):
        return None
    return max((abs(sa[u] - sb[u]) for u in sa.keys() & sb.keys()), default=0.0)


def optic_bodies() -> list:
    """Each optic of OPTICS on a rare-term query (requests_mix's kind 0: the
    driver path) and a head-term query (its kind 1, two head terms: the scan
    path through K1 or K13), and on the head-term query's fifth page of 20
    (past stage B's fused signal rows: pass 2 runs)."""
    mix = requests_mix(64)
    rare, head = mix[0]["query"], mix[1]["query"]
    return [{"query": q, "optic": src, **extra} for src in OPTICS.values()
            for q, extra in ((rare, {}), (head, {}), (head, {"page": 4, "numResults": 20}))]


@contextlib.contextmanager
def timed_calls(targets):
    """Wrap each (module, name, shape) of `targets` while the block runs:
    every call records shape(*args) with its ms (CUDA events around the
    call, synchronised after it; no ms without a card) → {name: [...]}."""
    import torch

    got, saved = {}, [(mod, name, getattr(mod, name)) for mod, name, _ in targets]

    def wrap(name, real, shape):
        def call(*a, **kw):
            rec = shape(*a, **kw)
            if not torch.cuda.is_available():
                out = real(*a, **kw)
            else:
                t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                t0.record()
                out = real(*a, **kw)
                t1.record()
                t1.synchronize()
                rec["ms"] = t0.elapsed_time(t1)
            got.setdefault(name, []).append(rec)
            return out
        return call

    for (mod, name, shape), (_, _, real) in zip(targets, saved):
        setattr(mod, name, wrap(name, real, shape))
    try:
        yield got
    finally:
        for mod, name, real in saved:
            setattr(mod, name, real)


def scoring_targets() -> tuple:
    """timed_calls' targets for the optic searches: the scoring kernels'
    launch wrappers (K1 with its table's form, slots T and largest entries
    E; K13; K2; K11; K3), and the ops/scoring.py entry points that
    plain_versions routes to the plain versions (their calls as the index
    makes them, numpy slots uploaded inside)."""
    from stract_tpu_torch.ops import kernels
    from stract_tpu_torch.ops import scoring as O

    def p_of(q):  # numpy slots, or tensors on the card
        return int(q.starts.shape[-1])

    launches = [
        (kernels, "stage_a", lambda seg, q, L, K, plan, *r, **kw: {
            "form": plan.form, "T": plan.slots, "E": plan.entries, "P": p_of(q), "L": L,
            "B": int(q.starts.shape[0])}),
        (kernels, "stage_a_merge", lambda seg, q, L, K, *r, **kw: {
            "form": kernels.merge_plan(p_of(q) * L).form, "P": p_of(q), "L": L,
            "B": int(q.starts.shape[0])}),
        (kernels, "stage_b", lambda seg, q, aggs, f, cand, *r, **kw: {
            "P": p_of(q), "Kd": int(cand.shape[-1]), "B": int(cand.shape[0])}),
        (kernels, "factors_join", lambda seg, starts, lens, cand, *r, **kw: {
            "P": int(starts.shape[-1]), "Kd": int(cand.shape[-1])}),
        (kernels, "signals_q16", lambda seg, a, f, cand, *r, **kw: {
            "P": int(a.P), "K": int(cand.shape[-1]), "B": int(cand.shape[0])})]
    entries = [
        (O, "score_candidates_batch", lambda seg, qs, L, K, *r, **kw: {"P": p_of(qs), "L": L}),
        (O, "score_driver_batch_with_signals", lambda seg, qs, f, d, *r, **kw: {
            "P": p_of(qs), "Kd": int(d.shape[-1])}),
        (O, "score_driver_batch", lambda seg, qs, f, d, *r, **kw: {
            "P": p_of(qs), "Kd": int(d.shape[-1])}),
        (O, "compute_signals_from_factors_batch_q16", lambda seg, qs, a, f, c: {
            "P": p_of(qs), "K": int(c.shape[-1])})]
    return launches, entries


@contextlib.contextmanager
def shard_paths():
    """Record the shard's path of each (query, segment) while the block runs
    (InvertedIndex._driver_docs: "driver Kd=<candidates>" or "scan")."""
    from stract_tpu_torch.index.inverted import InvertedIndex

    real, got = InvertedIndex.__dict__["_driver_docs"], []

    def driver_docs(seg, q):
        docs = real.__func__(seg, q)
        got.append("scan" if docs is None else f"driver Kd={len(docs)}")
        return docs

    InvertedIndex._driver_docs = staticmethod(driver_docs)
    try:
        yield got
    finally:
        InvertedIndex._driver_docs = real


def optic_phase(searcher, config: str, expect, card: str) -> dict:
    """The optic bodies served over HTTP (counts reset before, read after:
    every request answered, every kernel of `expect` launched; the host
    factor join timed); then each body's first page of 10 searched alone with
    K1's and K13's tables recorded, against the same search through the plain
    versions (page_match), and the filters held: every document of an O1
    page on site7.com, none of an O2 or O3 page on a site they discard.
    O3's head-term query must reach OPTIC_GATE[config]. → record."""
    from urllib.parse import urlparse

    from stract_tpu_torch.optics import Optic
    from stract_tpu_torch.searcher.query import SearchQuery

    t0 = time.perf_counter()
    bodies = optic_bodies()
    with join_timer() as jt:
        served = serve_phase(searcher, expect, bodies=bodies)
    firsts = [{**b, "numResults": 10} for b in bodies if "page" not in b]
    launches, entries = scoring_targets()
    kern, calls, plain, plain_calls = [], [], [], []
    for body in firsts:  # warm: the HTTP round served the same body
        with shard_paths() as paths, timed_calls(launches) as got:
            kern.append(searcher.search(SearchQuery.from_json(body)).to_json()["webpages"])
        calls.append({"paths": paths, **got})
    with plain_versions():
        for body in firsts:
            with timed_calls(entries) as got:
                plain.append(searcher.search(SearchQuery.from_json(body)).to_json()["webpages"])
            plain_calls.append(got)
    names = {src: name for name, src in OPTICS.items()}
    discarded = {"O2": Optic.parse(OPTICS["O2"]), "O3": Optic.parse(OPTICS["O3"])}
    err, rows = 0.0, []
    for body, wk, wp, got, pgot in zip(firsts, kern, plain, calls, plain_calls):
        err = max(err, page_match(wk, wp))
        name = names[body["optic"]]
        sites = [urlparse(w["url"]).netloc for w in wk]
        if name == "O1" and any(site != "site7.com" for site in sites):
            raise AssertionError(f"O1: a page holds other sites than site7.com: {sites}")
        if name in discarded and any(r.matches({"site": site})
                                     for r in discarded[name].rules for site in sites):
            raise AssertionError(f"{name}: a page holds a discarded site: {sites}")
        rows.append({"optic": name, "query": body["query"], "webpages": len(wk),
                     "path": ",".join(got.pop("paths")), "launches": got, "plain": pgot})
    if not any(r["webpages"] for r in rows):
        raise AssertionError("the optic pages are all empty")
    gate = OPTIC_GATE.get(config)
    if gate is not None:
        kernel, least = gate
        o3 = [r for r in rows if r["optic"] == "O3" and r["path"] == "scan"]
        key = "T" if kernel == "stage_a" else "P"
        reached = [t[key] for r in o3 for t in r["launches"].get(kernel, [])
                   if kernel != "stage_a" or t["form"] == "global"]
        if not reached or max(reached) < least:
            raise AssertionError(f"{config}: O3's scan-path query did not reach {kernel} "
                                 f"at {key} >= {least}: {o3}")
    rec = {"config": config, "requests": served["requests"], "failed": served["failed"],
           "qps": served["qps"], "p50_ms": served["p50_ms"], "p99_ms": served["p99_ms"],
           "host_join_calls": jt["calls"], "host_join_s": jt["seconds"],
           "launches": {k: v for k, v in served["launches"].items() if v},
           "top10_max_score_diff": err, "pages": rows, "seconds": time.perf_counter() - t0}
    for r in rows:
        log(f"[optics {config}] {r['optic']} {r['query']!r}: {r['path']} path, "
            f"{r['webpages']} webpages; launches {json.dumps(r['launches'])}; plain versions "
            f"{json.dumps(r['plain'])} card={card}")
    log(f"[result optics {config}] requests={rec['requests']} failed={rec['failed']} "
        f"qps={rec['qps']:.2f} p50_ms={rec['p50_ms']:.1f} p99_ms={rec['p99_ms']:.1f} "
        f"host_join_calls={jt['calls']} host_join_s={jt['seconds']:.3f} "
        f"top10_max_score_diff_vs_plain={err:.3g} launches={json.dumps(rec['launches'])} "
        f"seconds={rec['seconds']:.1f} card={card}")
    return rec


def linear_phase(index, card: str) -> dict:
    """The shard's linear model as `search_server.run` serves it: a
    LinearRegression with seeded weights over LINEAR_SIGNALS (its JSON read
    back) in a SearchService; one search_block_batch of the compare queries
    with the counts reset before and read after (K3, pass 2 at search time,
    must launch; every query's candidates carry their rows), then the
    top-10 pages of the coordinator over that shard against the plain
    versions (page_match). → record."""
    import numpy as np

    from stract_tpu_torch.entrypoint.search_server import SearchService
    from stract_tpu_torch.ops import kernels
    from stract_tpu_torch.ranking.models.linear import LinearRegression
    from stract_tpu_torch.searcher.api import ApiSearcher
    from stract_tpu_torch.searcher.distributed import LocalShardedSearcher
    from stract_tpu_torch.searcher.query import SearchQuery

    t0 = time.perf_counter()
    w = np.random.default_rng(SEED + 5).normal(size=len(LINEAR_SIGNALS))
    model = LinearRegression.from_json(LinearRegression(
        dict(zip(LINEAR_SIGNALS, w.tolist())), intercept=0.25).to_json())
    svc = SearchService(index, linear_model=model, batching=False, mesh=None)
    bodies = compare_bodies()
    kernels.reset_launches()
    res = svc.search_block_batch({"queries": [SearchQuery.from_json(b).to_json()
                                              for b in bodies]})
    launches = dict(kernels.LAUNCHES)
    if launches["signals_q16"] == 0 or launches["stage_b"] == 0:
        raise AssertionError(f"the linear model's round launched no pass 2: {launches}")
    if any(r["block"]["signals"] is None for r in res if len(r["block"]["doc"])):
        raise AssertionError("a candidate block came without its signal rows")
    api = ApiSearcher(LocalShardedSearcher([svc.searcher]))
    kern = [api.search(SearchQuery.from_json({**b, "numResults": 10})).to_json()["webpages"]
            for b in bodies]
    with plain_versions():
        plain = [api.search(SearchQuery.from_json({**b, "numResults": 10})).to_json()[
            "webpages"] for b in bodies]
    err = max(page_match(wk, wp) for wk, wp in zip(kern, plain))
    rec = {"weights": model.weights, "queries": len(bodies),
           "candidates": sum(len(r["block"]["doc"]) for r in res),
           "webpages": sum(len(p) for p in kern), "top10_max_score_diff_vs_plain": err,
           "launches": {k: v for k, v in launches.items() if v},
           "seconds": time.perf_counter() - t0}
    log(f"[result linear] {json.dumps(rec)} card={card}")
    return rec


def side_phase(searcher, card: str) -> dict:
    """The page's side answers over HTTP, once each, on the default index:
    the widget, a spell correction (a checker trained here from a seeded
    text, as tests/test_product_surface.py trains one), autosuggest, and the
    sidebar (the StackOverflow optic search: the corpus holds no QAPage, so
    it answers null). → {route: answer}."""
    import numpy as np

    from stract_tpu_torch.api.server import build_app
    from stract_tpu_torch.autosuggest import Autosuggest
    from stract_tpu_torch.main import ServerThread
    from stract_tpu_torch.searcher.api import ApiSearcher
    from stract_tpu_torch.spell import SpellChecker, StupidBackoff, TermFreqs
    from stract_tpu_torch.widgets import WidgetManager

    rng = np.random.default_rng(SEED + 6)
    words = ["rust", "programming", "language", "python", "search", "engine", "fast"]
    text = " . ".join(" ".join(rng.choice(words, 6)) for _ in range(200))
    freqs, lm = TermFreqs(), StupidBackoff()
    freqs.observe_text(text)
    lm.observe_text(text)
    api = ApiSearcher(searcher.searcher, searcher.pipeline, spell_checker=SpellChecker(freqs, lm),
                      widget_manager=WidgetManager())
    suggest = Autosuggest.from_queries(["rust programming", "rust language", "python search"])
    server = ServerThread(build_app(api, autosuggest=suggest, max_concurrency=4))
    out = {}
    try:
        for path, body in (("/beta/api/search/widget", {"query": "12 * (3 + 4)"}),
                           ("/beta/api/search/spellcheck", {"query": "rust programing langage"}),
                           ("/beta/api/autosuggest", {"q": "rust"}),
                           ("/beta/api/search/sidebar", {"query": "w1 w6"})):
            status, data, seconds = post(server.url + path, body)
            if status != 200:
                raise AssertionError(f"{path}: {status} {data}")
            out[path] = {"answer": data, "ms": seconds * 1e3}
    finally:
        server.stop()
    if out["/beta/api/search/widget"]["answer"]["widget"]["result"] != "84":
        raise AssertionError(f"the widget answered {out['/beta/api/search/widget']}")
    if out["/beta/api/search/spellcheck"]["answer"]["correction"]["corrected"] != \
            "rust programming language":
        raise AssertionError(f"the spell check answered {out['/beta/api/search/spellcheck']}")
    if [s["raw"] for s in out["/beta/api/autosuggest"]["answer"]] != ["rust language",
                                                                      "rust programming"]:
        raise AssertionError(f"autosuggest answered {out['/beta/api/autosuggest']}")
    if out["/beta/api/search/sidebar"]["answer"] != {"sidebar": None}:
        raise AssertionError(f"the sidebar answered {out['/beta/api/search/sidebar']}")
    log(f"[result side answers] {json.dumps(out)} card={card}")
    return out


def entity_articles(n: int, exact: list, seed: int) -> tuple:
    """n seeded wiki articles → ([(url, title, html)], {image key: bytes}):
    the `exact` titles first, then titles of 1-3 and abstracts of 12-20
    terms drawn from w300 ... w<PAGE_ENTITY_TERMS>; every PAGE_IMAGE_EVERY-th
    article has an infobox with an image, whose bytes the image store holds."""
    import numpy as np

    rng = np.random.default_rng(seed)
    terms = rng.integers(300, PAGE_ENTITY_TERMS, (n, 23))
    n_title, n_abs = rng.integers(1, 4, n), rng.integers(12, 21, n)
    arts, images = [], {}
    for i in range(n):
        row = [f"w{t}" for t in terms[i]]
        title = exact[i] if i < len(exact) else " ".join(row[:n_title[i]])
        box = ""
        if i % PAGE_IMAGE_EVERY == 0:
            key = f"e{i}.webp"
            images[key] = b"RIFF" + rng.bytes(int(rng.integers(512, 4096)))
            box = (f"<table class='infobox'><tr><td><img src='{key}'></td></tr><tr><th>id</th>"
                   f"<td>{i}</td></tr></table>")
        arts.append((f"E{i}", title, f"<html><body><p>{' '.join(row[3:3 + n_abs[i]])}</p>{box}"
                                     "</body></html>"))
    return arts, images


def entity_scores(index, query: str) -> dict:
    """EntityIndex.search's BM25 of every entity the query's terms reach,
    summed in sorted term order → {entity id: score} (search sums in the set
    order of its process: two processes may differ in the last bits)."""
    import math

    from stract_tpu_torch.tokenizer import tokenize

    n = len(index.entities)
    avg_title = max(sum(index.title_lens) / n, 1e-6)
    scores: dict = {}
    for tok in sorted(set(tokenize(query))):
        for postings, weight, avg in ((index.title_postings.get(tok, []), 4.0, avg_title),
                                      (index.abstract_postings.get(tok, []), 1.0, 50.0)):
            if postings:
                idf = math.log1p((n - len(postings) + 0.5) / (len(postings) + 0.5))
                for eid, tf in postings:
                    flen = index.title_lens[eid] if weight == 4.0 else 50
                    norm = 1.2 * (1 - 0.75 + 0.75 * flen / avg)
                    scores[eid] = scores.get(eid, 0.0) + weight * idf * tf * 2.2 / (tf + norm)
    return scores


def same_entity(index, query: str, got: dict, want: dict) -> bool:
    """The remote sidebar's entity is the local one, or one whose score ties
    the local winner's within rtol 1e-9 (the two processes' sums in other
    orders)."""
    if got == want:
        return True
    if got is None or want is None or got.get("type") != "entity":
        return False
    scores = entity_scores(index, query)
    top = max(scores.values(), default=0.0)
    return any(index.entities[eid] == got["value"] and s >= top * (1 - 1e-9)
               for eid, s in scores.items())


def call(url: str, method: str = "GET", body=None) -> tuple:
    """One HTTP request → (status, body bytes, content type, seconds); an
    error status is an answer, not an exception."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"content-type": "application/json"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            out = (resp.status, resp.read(), resp.headers.get_content_type())
    except urllib.error.HTTPError as e:
        out = (e.code, e.read(), e.headers.get_content_type())
    return (*out, time.perf_counter() - t0)


def page_phase(searcher, index, data_dir: str, card: str) -> dict:
    """The coordinator's whole page on the card over the 1M-doc corpus: a
    seeded ZIM of PAGE_ENTITIES articles written by the port's ZimWriter;
    `main.py indexer entity` builds the entity index as a process while the
    page graph (the corpus's URLs, the centrality job's 20M edges) and the
    host graph (its sites) are written; `main.py entity-search-server` serves
    the index and the image store as a process joined to gossip. The
    coordinator has no entity_index_path: entrypoint/api.py page_services
    gives it a RemoteSidebarManager and a RemoteEntityImageStore over the
    gossip-found server, beside the page graph; a local SidebarManager over
    the same index checks its answers. Over HTTP at CLIENTS clients: the
    request mix alone, then mixed with a sidebar request on each query,
    PAGE_LINKS requests on each link route, PAGE_IMAGES entity images (half
    misses), autosuggest/browser, the improvement routes, health, the spec
    and the UI. Every sidebar answer must be the local SidebarManager's or,
    where it finds no entity, the StackOverflow search's; every link route
    the graph's edges; every image hit the store's bytes; K1-K3 launched by
    the mixed round; search_websites' top-10s the batched path's, K1 and K2
    launched by it."""
    import numpy as np

    from stract_tpu_torch.api.server import build_app
    from stract_tpu_torch.autosuggest import Autosuggest
    from stract_tpu_torch.config import ApiConfig
    from stract_tpu_torch.distributed.cluster import Cluster, Service
    from stract_tpu_torch.entity_index import EntityIndex
    from stract_tpu_torch.entity_index.index import SidebarManager
    from stract_tpu_torch.entrypoint import bench_centrality as BC
    from stract_tpu_torch.entrypoint.api import page_services
    from stract_tpu_torch.image_store import ImageStore
    from stract_tpu_torch.main import ServerThread
    from stract_tpu_torch.ops import kernels
    from stract_tpu_torch.ranking.inbound_similarity import InboundSimilarity
    from stract_tpu_torch.searcher.api import ApiSearcher
    from stract_tpu_torch.searcher.query import SearchQuery
    from stract_tpu_torch.webgraph.store import write_graph
    from stract_tpu_torch.widgets import WidgetManager
    from stract_tpu_torch.zim import ZimWriter

    root = os.path.join(data_dir, "page")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    mix = requests_mix(N_REQUESTS)
    queries = [b["query"] for b in mix]
    t0 = time.perf_counter()
    arts, images = entity_articles(PAGE_ENTITIES, queries[::4], SEED + 7)
    zw = ZimWriter()
    for url, title, html in arts:
        zw.add_article(url, title, html)
    zw.write(os.path.join(root, "entities.zim"))
    ImageStore(os.path.join(root, "images")).insert_many(images)
    zim_s = time.perf_counter() - t0
    with open(os.path.join(root, "indexer.toml"), "w") as fh:
        fh.write(f'zim_path = "{root}/entities.zim"\noutput_path = "{root}/entities"\n')
    t0 = time.perf_counter()
    indexer = subprocess.Popen([sys.executable, "-m", "stract_tpu_torch.main", "indexer",
                                "entity", os.path.join(root, "indexer.toml")], cwd=ROOT,
                               stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        t1 = time.perf_counter()
        sites = index.segments[0].column("host_node_id").astype(np.int64)
        urls = [f"https://site{s}.com/doc{i}" for i, s in enumerate(sites.tolist())]
        src, dst = BC.make_edges(len(urls), GRAPH_EDGES, seed=0)
        pages = write_graph(os.path.join(root, "pages"), urls, src, dst)
        n_sites = int(sites.max()) + 1
        hs, hd = BC.make_edges(n_sites, PAGE_HOST_EDGES, seed=1)
        hosts = write_graph(os.path.join(root, "hosts"), [f"site{i}.com" for i in range(n_sites)],
                            hs, hd, host_graph=True)
        graph_s = time.perf_counter() - t1
        out, err = indexer.communicate(timeout=600)
    finally:
        if indexer.poll() is None:
            indexer.kill()
            indexer.wait()
    index_s = time.perf_counter() - t0
    if indexer.returncode != 0:
        raise RuntimeError(f"main.py indexer entity failed: {err[-2000:]}")
    local = SidebarManager(EntityIndex(os.path.join(root, "entities")))
    if len(local.index) != PAGE_ENTITIES or out.strip() != \
            f"indexed {PAGE_ENTITIES} entities → {root}/entities":
        raise AssertionError(f"the entity index holds {len(local.index)} entities: {out}")
    log(f"[page] ZIM of {PAGE_ENTITIES} articles and {len(images)} images in {zim_s:.1f}s; "
        f"the index built in {index_s:.1f}s beside the graphs' {graph_s:.1f}s "
        f"({pages.num_nodes} pages, {pages.num_edges} links; {hosts.num_nodes} hosts)")

    cluster = Cluster.join(Service("api"), interval=0.2)
    with open(os.path.join(root, "ess.toml"), "w") as fh:
        fh.write(f'index_path = "{root}/entities"\nimage_store_path = "{root}/images"\n'
                 f'[gossip]\nseeds = ["{cluster.gossip_addr[0]}:{cluster.gossip_addr[1]}"]\n')
    ess = subprocess.Popen([sys.executable, "-m", "stract_tpu_torch.main",
                            "entity-search-server", os.path.join(root, "ess.toml")], cwd=ROOT,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    server = None
    try:
        if cluster.await_member(lambda m: m.service.kind == "entity-search", timeout=300) is None:
            raise RuntimeError("the entity-search server did not join gossip: "
                               f"{ess.stderr.read()[-2000:] if ess.poll() is not None else ''}")
        sidebar, page_graph, remote_images = page_services(
            ApiConfig(page_graph_path=pages.path), cluster)
        api = ApiSearcher(searcher.searcher, searcher.pipeline, widget_manager=WidgetManager(),
                          sidebar_manager=sidebar)
        server = ServerThread(build_app(
            api, autosuggest=Autosuggest.from_queries(queries), similar_hosts=InboundSimilarity(
                hosts), page_graph=page_graph, image_store=remote_images,
            max_concurrency=2 * CLIENTS))
        rec = page_traffic(server.url, api, local, pages, hosts, mix, images, root)
    finally:
        if server is not None:
            server.stop()
        ess.kill()
        ess.wait()
        cluster.shutdown()

    # search_websites (the object path) against search_many on the compare bodies
    bodies = [{**b, "numResults": 10} for b in compare_bodies()]
    kernels.reset_launches()
    obj = [api.search_websites(SearchQuery.from_json(b)).to_json()["webpages"] for b in bodies]
    launches_obj = dict(kernels.LAUNCHES)
    batched = [p.to_json()["webpages"] for p in api.search_many([SearchQuery.from_json(b)
                                                                  for b in bodies])]
    rec["search_websites_max_score_diff"] = max(page_match(o, b) for o, b in zip(obj, batched))
    # K3 runs only for a page whose rows stage B's fused signals miss
    rec["search_websites_launches"] = {k: launches_obj[k] for k in SCORING}
    if sum(map(len, obj)) == 0 or any(launches_obj[k] == 0 for k in SCORING[:2]):
        raise AssertionError(f"search_websites found nothing or skipped K1 / K2: {launches_obj}")
    rec.update(entities=PAGE_ENTITIES, images=len(images), zim_s=zim_s, index_s=index_s,
               graph_s=graph_s, page_nodes=pages.num_nodes, page_edges=pages.num_edges,
               host_nodes=hosts.num_nodes)
    return rec


@contextlib.contextmanager
def timed_method(obj, name: str, seconds: list):
    """obj.name(...) timed on each call (seconds appended) while the block
    runs; the instance attribute shadowing the method goes after."""
    real = getattr(obj, name)

    def timed(*a, **kw):
        t0 = time.perf_counter()
        try:
            return real(*a, **kw)
        finally:
            seconds.append(time.perf_counter() - t0)
    setattr(obj, name, timed)
    try:
        yield seconds
    finally:
        delattr(obj, name)


def page_traffic(url: str, api, local, pages, hosts, mix: list, images: dict, root: str) -> dict:
    """The page phase's HTTP rounds and their checks (page_phase) → its record."""
    import numpy as np

    from stract_tpu_torch.api.server import MAX_LINKS
    from stract_tpu_torch.image_store import ImageStore
    from stract_tpu_torch.ops import kernels

    rng = np.random.default_rng(SEED + 8)
    search = [("search", "POST", "/beta/api/search", b) for b in mix]
    side = [("sidebar", "POST", "/beta/api/search/sidebar", {"query": b["query"]}) for b in mix]
    links = []
    for level, graph, key in (("page", pages, "page"), ("host", hosts, "host")):
        deg_in, deg_out = np.diff(graph.in_offsets), np.diff(graph.out_offsets)
        for way, deg in (("ingoing", deg_in), ("outgoing", deg_out)):
            live = np.flatnonzero(deg > 0)
            ranks = rng.choice(live, PAGE_LINKS - 1, replace=len(live) < PAGE_LINKS).tolist()
            ranks.append(int(np.argmax(deg)))  # the node past the link cap, where there is one
            for r in ranks:
                node = graph.name_of(r)
                shown = f"https://{node}/" if level == "host" and r % 2 else node
                links.append((f"{level}/{way}", "POST",
                              f"/beta/api/webgraph/{level}/{way}", {key: shown}, node))
    keys = sorted(images)
    hits = [keys[i] for i in rng.choice(len(keys), PAGE_IMAGES // 2, replace=False)]
    pics = [("entity_image", "GET", f"/beta/api/entity_image?imageId={k}", None)
            for k in hits + [f"missing{i}.webp" for i in range(PAGE_IMAGES - len(hits))]]
    misc = [("autosuggest/browser", "GET", f"/beta/api/autosuggest/browser?q={q.split()[0]}",
             None) for q in [b["query"] for b in mix[:4]]]
    misc += [("improvement/store", "POST", "/improvement/store",
              {"query": mix[i]["query"], "urls": ["https://site1.com/doc1"]}) for i in range(4)]
    misc += [("improvement/click", "POST", "/improvement/click", {"qid": "0" * 32, "click": "u"})
             for _ in range(4)]
    misc += [(p.strip("/") or "ui", "GET", p, None) for p in ("/health", "/health",
                                                               "/beta/api/docs/openapi.json",
                                                               "/", "/search", "/explore",
                                                               "/static/app.js")]

    def fire(reqs: list) -> tuple:
        t0 = time.perf_counter()
        with ThreadPoolExecutor(CLIENTS) as pool:
            got = list(pool.map(lambda r: call(url + r[2], r[1], r[3]), reqs))
        return got, time.perf_counter() - t0

    call(url + "/beta/api/search", "POST", {"query": "w1 w2"})  # warm-up, not counted
    plain, plain_s = fire(search)
    mixed_reqs = search + side + [r[:4] for r in links] + pics + misc
    order = rng.permutation(len(mixed_reqs))
    kernels.reset_launches()
    # a sidebar request's two parts, timed where the coordinator calls them:
    # the entity server's RPC, and on a miss the StackOverflow search
    parts = {"rpc": [], "stackoverflow": []}
    with timed_method(api.sidebar, "sidebar", parts["rpc"]), \
            timed_method(api, "stackoverflow_sidebar", parts["stackoverflow"]):
        shuffled, mixed_s = fire([mixed_reqs[i] for i in order])
    launches = {k: kernels.LAUNCHES[k] for k in SCORING}
    got = [None] * len(mixed_reqs)
    for i, g in zip(order, shuffled):
        got[i] = g
    bad = [(r[:3], g[0]) for r, g in zip(mixed_reqs, got)
           if g[0] != (404 if r[2].startswith("/beta/api/entity_image?imageId=missing")
                       else 200)]
    bad += [(r[:3], g[0]) for r, g in zip(search, plain) if g[0] != 200]
    if bad:
        raise AssertionError(f"{len(bad)} bad answers, the first {bad[0]}")
    if any(launches[k] == 0 for k in SCORING):
        raise AssertionError(f"K1-K3 were not all launched by the page's traffic: {launches}")

    # the sidebar: the local SidebarManager's entity, or the StackOverflow search's answer
    n = len(mix)
    lat = {"hit": [], "miss": []}
    for b, g in zip(mix, got[n:2 * n]):
        answer = json.loads(g[1])["sidebar"]
        want = local.sidebar(b["query"])
        if want is None:
            want = api.stackoverflow_sidebar(b["query"])
        want = json.loads(json.dumps(want))
        if not same_entity(local.index, b["query"], answer, want):
            raise AssertionError(f"the sidebar of {b['query']!r} answered {str(answer)[:200]}, "
                                 f"not {str(want)[:200]}")
        lat["hit" if local.sidebar(b["query"]) is not None else "miss"].append(g[3])
    # the link routes: the graph's first MAX_LINKS edges of the node
    capped = 0
    for r, g in zip(links, got[2 * n:2 * n + len(links)]):
        graph = pages if r[0].startswith("page") else hosts
        way = graph.backlinks if r[0].endswith("ingoing") else graph.forwardlinks
        ends = [graph.name_of(o) for o, _ in way(r[4])[:MAX_LINKS]]
        edges = json.loads(g[1])
        pair = ("from", "to") if r[0].endswith("ingoing") else ("to", "from")
        if [e[pair[0]] for e in edges] != ends or any(e[pair[1]] != r[4] for e in edges):
            raise AssertionError(f"{r[0]} of {r[4]} answered {len(edges)} edges, the graph has "
                                 f"{len(ends)}")
        capped += len(way(r[4])) > MAX_LINKS
    # the images: each hit the store's blob, byte for byte
    store = ImageStore(os.path.join(root, "images"))
    start = 2 * n + len(links)
    for r, g in zip(pics, got[start:start + len(pics)]):
        key = r[2].split("=", 1)[1]
        if g[0] == 200 and (g[1] != store.get(key) or g[1] != images[key]
                            or g[2] != "image/webp"):
            raise AssertionError(f"the entity image {key} is not the store's bytes")
    by_route: dict = {}
    for r, g in zip(mixed_reqs, got):
        by_route.setdefault(r[0], []).append(g[3])
    pct = lambda xs, q: float(np.quantile(xs, q) * 1e3) if xs else None  # noqa: E731
    return {"plain_requests": n, "plain_qps": n / plain_s, "mixed_requests": len(mixed_reqs),
            "mixed_qps": len(mixed_reqs) / mixed_s, "sidebar_hits": len(lat["hit"]),
            "sidebar_misses": len(lat["miss"]),
            "sidebar_hit_p50_ms": pct(lat["hit"], 0.5), "sidebar_hit_p99_ms": pct(lat["hit"], 0.99),
            "sidebar_miss_p50_ms": pct(lat["miss"], 0.5),
            "sidebar_miss_p99_ms": pct(lat["miss"], 0.99),
            "route_p50_ms": {k: pct(v, 0.5) for k, v in sorted(by_route.items())},
            "sidebar_parts_ms": {k: [pct(v, 0.5), pct(v, 0.99), max(v, default=0.0) * 1e3]
                                 for k, v in parts.items()},
            "links_past_the_cap": capped, "image_hits": len(hits), "launches": launches}


def config_phase(index_dir: str, default_pages: list, card: str) -> dict:
    """Each configuration of CONFIGS: built through build_searcher, served one
    round of the request mix over HTTP (pipeline off) with the host join
    timed, its top-10 pages compared with the default configuration's, and
    freed before the next. The q16 device join must give all of the default's
    top-10s; the merge's top-10s must match its own plain versions'; the
    verify round's pages must hold finite scores in order. →
    {name: record}."""
    import torch

    from stract_tpu_torch.main import build_searcher

    out = {}
    for name, (cfg, expect) in CONFIGS.items():
        t0 = time.perf_counter()
        searcher = build_searcher(index_dir, DEVICE, **cfg)
        index = searcher.searcher.searchers[0].index
        torch.cuda.synchronize()
        rows = index.device_segment_for(index.segments[0]).arrays.postings
        with join_timer() as jt:
            served = serve_phase(searcher, expect)
        pages = top10_pages(searcher)
        diffs = [page_diff(a, b, PAGE_RTOL) for a, b in zip(default_pages, pages)]
        same = sum(d is not None for d in diffs)
        rec = {"config": cfg, "qps": served["qps"], "p50_ms": served["p50_ms"],
               "p99_ms": served["p99_ms"], "requests": served["requests"], "failed": served["failed"],
               "postings_bytes": rows.numel() * 4, "postings_shape": list(rows.shape),
               "host_join_calls": jt["calls"], "host_join_s": jt["seconds"],
               "top10_equal_default": same, "compared": len(pages),
               "top10_max_score_diff": max((d for d in diffs if d is not None), default=None),
               "launches": {k: v for k, v in served["launches"].items() if v},
               "seconds": time.perf_counter() - t0}
        log(f"[config {name}] {json.dumps(rec)} card={card}")
        if cfg.get("device_join") and jt["calls"]:
            raise AssertionError("the device join still ran the host join")
        if name == "join" and same != len(pages):
            raise AssertionError(f"q16 device join: only {same} of {len(pages)} top-10 pages "
                                 "equal the default configuration's")
        if name == "verify":
            # verify_c truncates stage A's candidates before the exact verify, so a
            # page may differ where a default top-10 document ranks below 1,024 in
            # stage A: the agreement is printed, not gated; the pages must be sound
            scores = [[w["score"] for w in page] for page in pages]
            if not all(math.isfinite(x) for page in scores for x in page):
                raise AssertionError(f"verify_c: a non-finite page score: {scores}")
            if any(a < b for page in scores for a, b in zip(page, page[1:])):
                raise AssertionError(f"verify_c: a page out of order: {scores}")
            rec["top10_pair_overlap"] = [
                len({(w["url"], w["score"]) for w in a} & {(w["url"], w["score"]) for w in b})
                for a, b in zip(default_pages, pages)]
            log(f"[config verify] top-10 (doc, score) pairs shared with the default: "
                f"{rec['top10_pair_overlap']} of {[len(p) for p in pages]} card={card}")
        if name == "merge":  # its pages against the same configuration's plain versions
            rec["vs_plain"] = compare_phase(searcher)
            log(f"[config merge] top-10 kernels vs plain versions: {json.dumps(rec['vs_plain'])} "
                f"card={card}")
        if name in OPTIC_GATE:  # the optic bodies in this configuration's round
            rec["optics"] = optic_phase(searcher, name, expect, card)
        out[name] = rec
        del searcher, index, rows
        torch.cuda.empty_cache()
    return out


def config_kernel_phase(index_dir: str, dual_dir: str) -> tuple:
    """The device-only entry points driven once at the main shapes (launch
    counts reset just before, read just after): factors_join over stage A's
    candidates (held to the host join), compute_signals_batch over the slots'
    first L rows, rerank_topk_batch over the f16 title embeddings of stage
    B's top RERANK_K docs with the trained dual encoder's query embeddings
    (held to a numpy rerank). Then K1 on q8 rows, K1 with UB, K11 alone and
    inside stage B and pass 2, K12 and K10 against their plain versions on
    the same slots (K10's indices equal but for ties within its tolerance;
    also at RERANK_LONG, k = K, in f32, f16 and bf16, and on -0 / +0
    totals, +0 first); then K13 at P = MERGE_P: the network's keys and payloads
    bit-equal to the plain merge's, the candidates at stage A's tolerance;
    the network alone on doc-ordered slots (a sort there) timed beside
    torch.sort of the keys with a gather of the payloads.
    → (rows as kernel_phase's, launches of the driven calls, {kernel: the
    library call's ms})."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from stract_tpu_torch import bench_corpus as bc
    from stract_tpu_torch.index.device import DeviceSegment
    from stract_tpu_torch.index.inverted import InvertedIndex
    from stract_tpu_torch.models.dual_encoder import DualEncoder
    from stract_tpu_torch.ops import dense_rerank as R
    from stract_tpu_torch.ops import kernels
    from stract_tpu_torch.ops import scoring as O
    from stract_tpu_torch.ranking.computer import QueryContext, build_slots

    index = InvertedIndex(index_dir, DEVICE)
    seg = index.segments[0]
    dev, dev8 = index.device_segment_for(seg), DeviceSegment(seg, DEVICE, "q8")
    nd = seg.num_docs
    T = lambda x, dt=torch.int32: torch.as_tensor(x, dtype=dt).to(DEVICE)  # noqa: E731
    queries = bc.sample_queries(np.random.default_rng(SEED), B)
    ctxs = [QueryContext(raw=q, simple_terms=q.split(), current_ts=NOW) for q in queries]
    slots = [build_slots(c, seg, index.num_docs, index.region_scores()) for c in ctxs]

    comp, Pc = compacted_slots(slots)
    qc_np = O.stack([q for q, _ in comp])
    qc, ac = O.to_tensors(qc_np, DEVICE), O.to_tensors(O.stack([a for _, a in comp]), DEVICE)

    def augmented(d):
        aug = [InvertedIndex._augment_with_impact(seg, d, q, L, 0.5) for q, _ in slots]
        return (O.to_tensors(O.stack([a[0] for a in aug]), DEVICE),
                T(np.stack([a[1] for a in aug]), torch.float32),
                T(np.array([a[2] for a in aug], dtype=np.float32), torch.float32))
    qa, ub, ubt = augmented(dev)
    qa8, ub8, ubt8 = augmented(dev8)
    if not (float(ubt.max()) > 0 and float(ubt8.max()) > 0):
        raise AssertionError("no sampled query has a truncated slot: UB would test nothing")
    scanned = int(qa.lens.clamp(max=L).sum())
    slot_bytes = sum(x.numel() * 4 for x in qa)

    # ---- the device-only entry points, once, counted --------------------------------
    cand, _ = O.score_candidates_batch(dev.arrays, qa, L, C, True, True)
    cand_np = cand.cpu().numpy()
    host = np.zeros((B, Pc, KD), np.int32)
    for j, (q, _) in enumerate(comp):
        InvertedIndex._slot_factors_for(seg, q, cand_np[j], out=host[j])
    sb_docs, sb_scores = O.score_driver_batch(dev.arrays, qc, T(host), cand, True, OUT_K)
    page = sb_docs[:, :512].contiguous()
    dual = DualEncoder.load(dual_dir, device=DEVICE)
    q_emb = torch.as_tensor(np.asarray(dual.embed(queries)), dtype=torch.float32).to(DEVICE)
    del dual
    top = sb_docs[:, :RERANK_K].cpu().numpy().astype(np.int64)
    real = top < nd
    title = seg.embeddings("title_embeddings")
    if title is None or title.dtype != np.float16:
        raise AssertionError("the corpus has no f16 title embedding column")
    emb = T(np.where(real[..., None], title[np.where(real, top, 0)], 0), torch.float16)
    base = sb_scores[:, :RERANK_K]
    base = torch.where(torch.isfinite(base), base, torch.full_like(base, -1e30))  # pad rows last
    torch.cuda.synchronize()
    kernels.reset_launches()
    joined = O.factors_join(dev.arrays, qc.starts, qc.lens, cand)
    prefix_sig = O.compute_signals_batch(dev.arrays, qc, ac, page, L)
    r_idx, r_scores = R.rerank_topk_batch(emb, q_emb, base, RERANK_W, RERANK_TOP)
    torch.cuda.synchronize()
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    if launches != dict.fromkeys(DIRECT, 1):
        raise AssertionError(f"the device-only entry points launched {launches}")
    if not np.array_equal(joined.cpu().numpy(), host):
        raise AssertionError("the device join differs from the host join")
    if not (torch.isfinite(prefix_sig).all() and bool((prefix_sig != 0).any())):
        raise AssertionError("prefix signals are empty or not finite")
    # a numpy rerank of the same inputs (f64 sums), ties to the lower index
    e64 = emb.cpu().numpy().astype(np.float64)
    norms = np.linalg.norm(e64, axis=2)
    sims = np.where(norms > 1e-6, np.einsum("bkh,bh->bk", e64, q_emb.cpu().numpy().astype(
        np.float64)) / np.maximum(norms, 1e-6), 0.0)
    total = base.cpu().numpy().astype(np.float64) + RERANK_W * sims
    ref_idx = np.argsort(-total, axis=1, kind="stable")[:, :RERANK_TOP]
    for b in range(B):
        topk_match(ref_idx[b], np.take_along_axis(total, ref_idx, 1)[b].astype(np.float32),
                   r_idx[b].cpu().numpy(), r_scores[b].cpu().numpy(), -1, 1e-5, 1e-5)

    rows = []
    def add(name, err, run_k, run_p, shape, nbytes, ops, iters=10):  # noqa: E306
        rows.append((name, True, err, time_ms(run_k), time_ms(run_p, iters), shape, nbytes, ops))

    # ---- K1 on q8 rows, K1 with UB ------------------------------------------------
    for name, arrays, q_, u_, t_, row_b in (("stage_a_q8", dev8.arrays, qa8, None, None, 8),
                                            ("stage_a_ub", dev.arrays, qa, ub, ubt, 12),
                                            ("stage_a_ub_q8", dev8.arrays, qa8, ub8, ubt8, 8)):
        run_k = lambda: O.score_candidates_batch(arrays, q_, L, C, True, True, u_, t_)  # noqa
        run_p = lambda: O.score_candidates_batch_plain(arrays, q_, L, C, True, True, u_, t_)  # noqa
        d_k, s_k = [x.cpu().numpy() for x in run_k()]
        d_p, s_p = [x.cpu().numpy() for x in run_p()]
        err = max(topk_match(d_p[b], s_p[b], d_k[b], s_k[b], nd, *A_TOL) for b in range(B))
        if not np.isfinite(s_k).any():
            raise AssertionError(f"{name} found no candidates")
        ub_bytes = 0 if u_ is None else 4 * (u_.numel() + t_.numel())
        add(name, err, run_k, run_p, (C, f"{row_b}B rows"),
            row_b * scanned + slot_bytes + ub_bytes + 8 * B * C, 10 * scanned)

    # ---- K11 alone: bit-equal to the plain join, on both layouts ---------------------
    lens = qc.lens.cpu().numpy().astype(np.int64)
    probes = int((np.ceil(np.log2(lens + 1)) * KD).sum())  # the compares this run's searches make
    found = int((joined != 0).sum())
    # bytes once: starts, lens, candidates; the doc word of each distinct row the
    # searches touch; the factor word of each row found
    join_in = 4 * (2 * B * Pc + B * KD) + 4 * search_rows(lens, KD) + 4 * found
    for arrays in (dev.arrays, dev8.arrays):
        f_k = O.factors_join(arrays, qc.starts, qc.lens, cand)
        if not torch.equal(f_k, O.factors_join_plain(arrays.postings, qc.starts, qc.lens, cand)):
            raise AssertionError("stract_factors_join differs from the plain join")
    add("factors_join", 0.0, lambda: O.factors_join(dev.arrays, qc.starts, qc.lens, cand),
        lambda: O.factors_join_plain(dev.arrays.postings, qc.starts, qc.lens, cand),
        KD, join_in + 4 * B * Pc * KD, probes, iters=3)

    # ---- K11 over a batch that crosses the join plan's length threshold -----------
    join_cases(seg, (dev.arrays, dev8.arrays), qc_np, ac, cand)

    # ---- joined stage B -------------------------------------------------------------
    run_k = lambda: O.score_driver_joined_batch(dev.arrays, qc, cand, True, OUT_K)  # noqa: E731
    run_p = lambda: O.score_driver_joined_batch_plain(dev.arrays, qc, cand, True, OUT_K)  # noqa
    (dk, sk), (dp, sp) = ([x.cpu().numpy() for x in r()] for r in (run_k, run_p))
    err = max(topk_match(dp[b], sp[b], dk[b], sk[b], nd, *B_TOL) for b in range(B))
    # and the host-joined verify (K2) bit for bit: the same factors folded in the
    # same order and sorted by the same network
    if not (np.array_equal(dk, sb_docs.cpu().numpy())
            and np.array_equal(sk, sb_scores.cpu().numpy())):
        raise AssertionError("joined stage B differs from stage B over the host join")
    add("stage_b_joined", err, run_k, run_p, KD,
        join_in + sum(x.numel() * 4 for x in qc) + 8 * B * OUT_K, probes + 10 * B * Pc * KD,
        iters=3)

    # ---- joined pass 2: K3 over the host join, bit for bit, at K = 128 and 512 -------
    page_np = page.cpu().numpy()
    for K in (PAGE_K, 512):
        pg = page[:, :K].contiguous()
        hp = np.zeros((B, Pc, K), np.int32)
        for j, (q, _) in enumerate(comp):
            InvertedIndex._slot_factors_for(seg, q, page_np[j, :K], out=hp[j])
        hp = T(hp)
        (qk, sck), (q3, sc3) = (O.compute_signals_joined_batch_q16(dev.arrays, qc, ac, pg),
                                O.compute_signals_from_factors_batch_q16(dev.arrays, qc, ac, hp,
                                                                         pg))
        fk, f3 = (O.compute_signals_joined_batch(dev.arrays, qc, ac, pg),
                  O._signals_k3(dev.arrays, qc, ac, hp, pg, False))
        if not (torch.equal(qk, q3) and torch.equal(sck.view(torch.int32), sc3.view(torch.int32))
                and torch.equal(fk.view(torch.int32), f3.view(torch.int32))):
            raise AssertionError(f"joined pass 2 at K = {K} differs from K3 over the host join")
    log(f"[config kernels] joined pass 2 at K = {PAGE_K} and 512: q16 rows, scales and f32 "
        f"rows bit-equal to K3 over the host join")

    # ---- joined pass 2 at K = 512 against its plain version, K12 ------------------------
    lens_p = int((np.ceil(np.log2(lens + 1)) * 512).sum())
    found_p = int((O.factors_join(dev.arrays, qc.starts, qc.lens, page) != 0).sum())
    sig_bytes = (4 * B * 512 + sum(x.numel() * 4 for x in (*qc, *ac)) + 2 * B * 46 * 512
                 + 4 * B * 46)
    run_k = lambda: O.compute_signals_joined_batch_q16(dev.arrays, qc, ac, page)  # noqa: E731
    run_p = lambda: O.quantize_signals(  # noqa: E731
        O.compute_signals_joined_batch_plain(dev.arrays, qc, ac, page))
    (qk, sck), (qp, scp) = run_k(), run_p()
    torch.testing.assert_close(sck, scp, rtol=1e-5, atol=1e-35)
    step = int((qk.int() - qp.int()).abs().max().item())
    if step > 1:
        raise AssertionError(f"joined pass-2 q16 rows differ by {step} steps")
    err = float(np.abs(O.dequantize_signals(qk, sck) - O.dequantize_signals(qp, scp)).max())
    add("signals_joined", err, run_k, run_p, 512,
        sig_bytes + 4 * search_rows(lens, 512) + 4 * found_p,
        lens_p + 2 * 46 * B * Pc * 512, iters=3)

    steps = O._lookup_steps(L)
    run_k = lambda: O.compute_signals_batch(dev.arrays, qc, ac, page, L)  # noqa: E731
    run_p = lambda: O.compute_signals_batch_plain(dev.arrays, qc, ac, page, L)  # noqa: E731
    sig_k, sig_p = run_k(), run_p()
    torch.testing.assert_close(sig_k, sig_p, rtol=P12_TOL[0], atol=P12_TOL[1])
    n_slots = int((lens > 0).sum())
    found_l = int((O._slot_factor_lookup(*O._gather_packed(dev.arrays, qc, L), page, L)
                   != 0).sum())
    add("signals_prefix", float((sig_k - sig_p).abs().max()), run_k, run_p, 512,
        sig_bytes + 2 * B * 46 * 512 + 4 * search_rows(lens, 512, steps, cap=L) + 4 * found_l,
        n_slots * 512 * steps + 2 * 46 * B * Pc * 512, iters=3)
    plan = kernels.prefix_plan(Pc, L, 512, 46)
    blocks = -(-512 // plan.cands) * B
    if blocks <= B:
        raise AssertionError(f"K12 takes {blocks} blocks for {B} queries")
    log(f"[config kernels] K12 at P = {Pc}, L = {L}, K = 512: {blocks} blocks for {B} queries "
        f"(plan {tuple(plan)})")
    # K12 over PREFIX_WIDE_P full-length slots a query: 64 prefixes of L rows
    # pass one block's staging (kernels.prefix_plan takes them in groups)
    rng = np.random.default_rng(SEED + 12)
    qw_np = full_slots(seg, O.stack([pad_slots(q, PREFIX_WIDE_P) for q, _ in comp]), rng)
    plan = kernels.prefix_plan(PREFIX_WIDE_P, L, 512, 46)
    if not 0 < plan.group < PREFIX_WIDE_P:
        raise AssertionError(f"K12's plan {plan} stages {PREFIX_WIDE_P} prefixes in one group")
    ac_np = O.stack([a for _, a in comp])
    cyc = np.arange(PREFIX_WIDE_P) % Pc
    aw = O.to_tensors(ac_np._replace(**{f: np.asarray(getattr(ac_np, f))[..., cyc]
                                        for f in ac_np._fields}), DEVICE)
    qw = O.to_tensors(qw_np, DEVICE)
    heads = [np.concatenate([np.arange(s, s + L) for s in qw_np.starts[j]]) for j in range(B)]
    rows_w = T(np.stack([rng.choice(h, 256, replace=False) for h in heads]), torch.int64)
    page_w = torch.cat([dev.arrays.postings[rows_w, 0], page[:, :256]], dim=1).contiguous()
    run_k = lambda: O.compute_signals_batch(dev.arrays, qw, aw, page_w, L)  # noqa: E731
    run_p = lambda: O.compute_signals_batch_plain(dev.arrays, qw, aw, page_w, L)  # noqa: E731
    sig_k, sig_p = run_k(), run_p()
    torch.testing.assert_close(sig_k, sig_p, rtol=P12_TOL[0], atol=P12_TOL[1])
    lens_w = qw_np.lens.astype(np.int64)
    found_w = int((O._slot_factor_lookup(*O._gather_packed(dev.arrays, qw, L), page_w, L)
                   != 0).sum())
    add("signals_prefix", float((sig_k - sig_p).abs().max()), run_k, run_p,
        (512, f"{PREFIX_WIDE_P} full slots"),
        4 * B * 512 + sum(x.numel() * 4 for x in (*qw, *aw)) + 4 * B * 46 * 512
        + 4 * search_rows(lens_w, 512, steps, cap=L) + 4 * found_w,
        int((lens_w > 0).sum()) * 512 * steps + 2 * 46 * B * PREFIX_WIDE_P * 512, iters=3)
    log(f"[config kernels] K12 over {PREFIX_WIDE_P} full slots a query (plan {tuple(plan)}): "
        f"within rtol {P12_TOL[0]} of its plain version, {found_w} factors found")

    # ---- K10 -------------------------------------------------------------------------
    run_k = lambda: R.rerank_topk_batch(emb, q_emb, base, RERANK_W, RERANK_TOP)  # noqa: E731
    run_p = lambda: R.rerank_topk_batch_plain(emb, q_emb, base, RERANK_W, RERANK_TOP)  # noqa
    err = rerank_match(run_k(), run_p())
    H = emb.shape[2]
    add("dense_rerank", err, run_k, run_p, RERANK_K,
        2 * emb.numel() + 4 * (q_emb.numel() + base.numel()) + 8 * B * RERANK_TOP,
        4 * B * RERANK_K * H)
    e32 = emb.float()
    rerank_lib = time_ms(lambda: torch.topk(base + RERANK_W * torch.einsum(
        "bkh,bh->bk", F.normalize(e32, dim=2, eps=1e-6), q_emb), RERANK_TOP))
    log(f"[config kernels] K10 beside three PyTorch calls (normalize, einsum, topk; not one "
        f"call): {rerank_lib:.3f} ms")
    # past the old kernel's 4,096 candidates and 1,024 dims, every candidate kept
    g = torch.Generator().manual_seed(10)
    Kl, Hl = RERANK_LONG
    e_l = F.normalize(torch.randn((4, Kl, Hl), generator=g), dim=2)
    e_l[:, ::10] = 0
    q_l, b_l = torch.randn((4, Hl), generator=g).to(DEVICE), torch.randn((4, Kl), generator=g)
    b_l = b_l.to(DEVICE)
    for dt in (torch.float32, torch.float16, torch.bfloat16):
        e_d = e_l.to(DEVICE, dt)
        lerr = rerank_match(R.rerank_topk_batch(e_d, q_l, b_l, 0.5, Kl),
                            R.rerank_topk_batch_plain(e_d, q_l, b_l, 0.5, Kl))
        log(f"[config kernels] K10 at K = {Kl}, H = {Hl}, k = K, {dt}: within rtol "
            f"{RERANK_TOL[0]} atol {RERANK_TOL[1]} of its plain version (max {lerr:.2g})")
    del e_l, e_d
    z_emb, z_q = torch.zeros((2, 4, 64), device=DEVICE), torch.ones((2, 64), device=DEVICE)
    z_base = torch.tensor([[-0.0, 0.0, -0.0, 0.0], [0.0, -0.0, -0.0, 0.0]], device=DEVICE)
    z_k = R.rerank_topk_batch(z_emb, z_q, z_base, -1.0, 4)
    z_p = R.rerank_topk_batch_plain(z_emb, z_q, z_base, -1.0, 4)
    if z_k[0].tolist() != [[1, 3, 0, 2], [0, 3, 1, 2]] or not torch.equal(z_k[0], z_p[0]) or \
            not torch.equal(torch.signbit(z_k[1]), torch.signbit(z_p[1])):
        raise AssertionError(f"K10 orders -0 / +0 totals as {z_k[0].tolist()}, not +0 first")
    log("[config kernels] K10 on -0 / +0 totals: +0 above -0, ties to the lower index, as "
        "its plain version and lax.top_k")

    # ---- K13: stage A through the merge network -----------------------------------
    qm = O.to_tensors(O.stack([pad_slots(InvertedIndex._augment_with_impact(seg, dev, q)[0],
                                         MERGE_P) for q, _ in slots]), DEVICE)
    N = MERGE_P * L
    kk, ck, ak = O.stage_a_network(dev.arrays, qm, L)
    keys, contrib, aux, _ = O._stage_a_entries(dev.arrays, qm, L)
    kp, (cp, ap) = O.merge_sorted_tiles_plain(keys, contrib, aux)
    if not (torch.equal(kk, kp) and torch.equal(ak, ap)
            and torch.equal(ck.view(torch.int32), cp.view(torch.int32))):
        raise AssertionError("the merge network's keys or payloads differ from the plain merge")
    ascending = int((kk[:, 1:] >= kk[:, :-1]).all(dim=1).sum())
    run_k = lambda: O.score_candidates_batch(dev.arrays, qm, L, C, True, True, merge=True)  # noqa
    run_p = lambda: O.score_candidates_batch_plain(dev.arrays, qm, L, C, True, True,  # noqa
                                                   merge=True)
    (d_k, s_k), (d_p, s_p) = ([x.cpu().numpy() for x in r()] for r in (run_k, run_p))
    err = max(topk_runs_match(d_p[b], s_p[b], d_k[b], s_k[b], nd, *A_TOL) for b in range(B))
    if not np.isfinite(s_k).any():
        raise AssertionError("the merge found no candidates")
    stages = sum(int(np.log2(2 * L * 2 ** r)) for r in range(int(np.log2(MERGE_P))))
    scanned_m = int(qm.lens.clamp(max=L).sum())
    add("stage_a_merge", err, run_k, run_p, (MERGE_P, L, C),
        12 * scanned_m + sum(x.numel() * 4 for x in qm) + 8 * B * C,
        B * (N // 2 * stages + 10 * N))
    # the network alone (the K = 0 launch) beside torch.sort + gathers of the
    # same entries, like for like: on the queries' own doc-ordered slots
    # (no impact prefix), whose tiles ascend, so the merge is a sort
    qd = O.to_tensors(O.stack([pad_slots(q, MERGE_P) for q, _ in slots]), DEVICE)
    kn = O.stage_a_network(dev.arrays, qd, L)[0]
    asc = [b for b in range(B) if bool((kn[b, 1:] >= kn[b, :-1]).all())]
    if not asc:
        raise AssertionError("no query's doc-ordered slots merge into ascending keys")
    qd = O.QuerySlots(*(x[asc] for x in qd))
    keys, contrib, aux, _ = O._stage_a_entries(dev.arrays, qd, L)
    kf, cf, af = (x.reshape(len(asc), -1) for x in (keys, contrib, aux))

    def sort_gather():
        sk, perm = torch.sort(kf, dim=-1)
        return sk, cf.gather(1, perm), af.gather(1, perm)
    if not torch.equal(sort_gather()[0], O.stage_a_network(dev.arrays, qd, L)[0]):
        raise AssertionError("the merge network's keys differ from torch.sort's on ascending rows")
    net_ms = time_ms(lambda: O.stage_a_network(dev.arrays, qd, L))
    sort_ms = time_ms(sort_gather)
    log(f"[config kernels] K13 at B={B} P={MERGE_P} L={L} C={C} "
        f"({kernels.merge_plan(N)}): network bit-equal to the "
        f"plain merge; {ascending} of {B} queries' merged keys ascending (the others hold "
        f"tf-ordered impact slots). The network alone (the K = 0 launch) on {len(asc)} "
        f"queries' doc-ordered slots, whose keys it sorts as torch.sort does: {net_ms:.4f} ms "
        f"beside torch.sort + gathers {sort_ms:.4f} ms (the whole of stage A has no library "
        f"call)")
    del kf, cf, af, keys, contrib, aux, kp, cp, ap
    # K13 in its other cases: MERGE_WIDE_P full-length slots a query (the
    # select's keys past 2 blocks' shared memory), and the doc-ordered batch
    # with its first query's slots windows of one list, so that its runs
    # cross every tile boundary of the global form; each network bit-equal to
    # the plain merge, the candidates against the plain version summing in
    # f64 (plain64: 65,536 and more live entries a query), two calls bit-equal
    wide = full_slots(seg, O.stack([pad_slots(q, MERGE_WIDE_P) for q, _ in slots]),
                      np.random.default_rng(SEED))
    for name, q_np in (("wide", wide),
                       ("crossing", crossing_slots(seg, O.stack([pad_slots(q, MERGE_P)
                                                                 for q, _ in slots])))):
        q_t = O.to_tensors(q_np, DEVICE)
        N_ = q_t.starts.shape[1] * L
        net = O.stage_a_network(dev.arrays, q_t, L)
        keys, contrib, aux, _ = O._stage_a_entries(dev.arrays, q_t, L)
        kp, (cp, ap) = O.merge_sorted_tiles_plain(keys, contrib, aux)
        del keys, contrib, aux
        if not (torch.equal(net[0], kp) and torch.equal(net[2], ap)
                and torch.equal(net[1].view(torch.int32), cp.view(torch.int32))):
            raise AssertionError(f"K13's network ({name}) differs from the plain merge")
        tile = kernels.MERGE_TILE
        crossed = sum(int(kp[0, r * tile - 1]) >> 6 == int(kp[0, r * tile]) >> 6
                      for r in range(1, N_ // tile))
        if name == "crossing" and crossed != N_ // tile - 1:
            raise AssertionError(f"the crossing query's runs cross {crossed} of "
                                 f"{N_ // tile - 1} tile boundaries")
        del net, kp, cp, ap
        run_k = lambda: O.score_candidates_batch(dev.arrays, q_t, L, C, True, True,  # noqa
                                                 merge=True)
        (d_k, s_k), (d_2, s_2) = run_k(), run_k()
        if not (torch.equal(d_k, d_2) and torch.equal(s_k.view(torch.int32),
                                                      s_2.view(torch.int32))):
            raise AssertionError(f"two K13 calls ({name}) differ")
        seg64, q64 = plain64(dev.arrays, q_np, DEVICE)
        d_p, s_p = O.score_candidates_batch_plain(seg64, q64, L, C, True, True, merge=True)
        d_k, s_k, d_p, s_p = (x.cpu().numpy() for x in (d_k, s_k, d_p, s_p.float()))
        err = max(topk_runs_match(d_p[b], s_p[b], d_k[b], s_k[b], nd, *A_TOL) for b in range(B))
        if not np.isfinite(s_k).any():
            raise AssertionError(f"K13 ({name}) found no candidates")
        rows.append(("stage_a_merge", True, err, time_ms(run_k), float("nan"),
                     (q_t.starts.shape[1], L, C, name), 0, 0))
        log(f"[config kernels] K13 {name} at B={B} P={q_t.starts.shape[1]} L={L} C={C} "
            f"({kernels.merge_plan(N_)}): network bit-equal, candidates within {err:.3g} of "
            f"the plain version in f64, two calls bit-equal; the first query's runs cross "
            f"{crossed} of {N_ // tile - 1} tile boundaries; {rows[-1][3]:.4f} ms")
        del seg64, q64
    lib_ms = {"dense_rerank": rerank_lib}
    return rows, launches, lib_ms


def train_phase(index_dir: str, out_dir: str, tok) -> dict:
    """The encoder-training path: train_bench_encoders at its defaults with
    the cross encoder warm-started from the dual trunk, distilled from it and
    read out by the masked mean (the recipe the JAX package's records name:
    a CLS readout on the mean-pooled trunk stalls), on the card; launch
    counts reset just before and read just after. → {"dual", "cross":
    checkpoint dirs, "summary", "timing", "launches"}."""
    from stract_tpu_torch.entrypoint import train_bench_encoders as TBE
    from stract_tpu_torch.ops import kernels

    args = TBE.parser().parse_args(["--docs", str(DOCS), "--steps", str(TRAIN_STEPS),
                                    "--batch", str(TRAIN_B // 2), "--train-len",
                                    str(TRAIN_T), "--distill-cross", "--cross-pool", "mean",
                                    "--device", DEVICE])
    if args.steps != 400:
        log(f"[train] steps cut from the tool's 400 to {args.steps}")
    kernels.reset_launches()
    summary, timing = TBE.run(args, index_dir, out_dir, tokenizer=tok, log=log)
    launches = dict(kernels.LAUNCHES)
    log(f"[train] {json.dumps(summary)}")
    for kind in ("dual", "cross"):
        t = timing[kind]
        log(f"[train] {kind}: {t['steps']} steps in {t['seconds']:.1f}s: "
            f"{t['seconds'] / t['steps']:.4f} s/step, {t['steps'] / t['seconds']:.2f} steps/s; "
            f"loss {summary[f'{kind}_loss'][0]} -> {summary[f'{kind}_loss'][1]} "
            f"(mean of the first / last 10 steps)")
    log(f"[train] held-out pos>neg: dual {summary['dual_heldout_acc']}, cross "
        f"{summary['cross_heldout_acc']}; cross vs teacher spearman "
        f"{summary['cross_vs_teacher_spearman']}; launches {json.dumps(launches)}")
    if summary["dual_heldout_acc"] < MIN_DUAL_ACC:
        raise AssertionError(f"dual encoder held-out accuracy {summary['dual_heldout_acc']} "
                             f"is below {MIN_DUAL_ACC}")
    if any(launches[k] == 0 for k in TRAINING):
        raise AssertionError(f"a kernel was not launched by the training: {launches}")
    return {"dual": os.path.join(out_dir, f"dual_encoder-{DOCS}"),
            "cross": os.path.join(out_dir, f"cross_encoder-{DOCS}"),
            "summary": summary, "timing": timing, "launches": launches}


def index_bodies(seg, rng) -> list:
    """The index phase's round: 2- and 3-term queries of the pages' stop
    words (in nearly every page, their groups pass the driver budget of
    4,096 postings: the scan path, K1), of stems and title words (the driver
    path), and deep pages (pass 2, K3)."""
    from stract_tpu_torch import warc_corpus as WC

    out = []
    for i in range(INDEX_QUERIES):
        n = 2 + i % 2
        if i % 4 == 3:
            words = seg.stored_doc(int(rng.integers(seg.num_docs)))["title"].lower().split()[:n]
        else:
            vocab = WC.EN_STOP[:12] if i % 4 < 2 else WC.EN_STEMS[:24]
            words = [vocab[k] for k in rng.choice(len(vocab), n, replace=False)]
        body = {"query": " ".join(words)}
        if i % 4 == 1:
            body.update(page=4, numResults=20)
        out.append(body)
    return out


def index_phase(data_dir: str, dual_dir: str, card: str) -> dict:
    """The port builds its own index on the card's machine: INDEX_FILES
    seeded WARC files of INDEX_PAGES pages (stract_tpu_torch/warc_corpus.py)
    → the host graph (entrypoint/webgraph_build.py) → its harmonic
    centrality (run_harmonic: K6a / K6b) → entrypoint/indexer.py run with the
    host centrality and the trained dual encoder on the card (title and
    keyword embeddings: K5a-d), one segment a file, then merge_all; `main.py
    indexer search` and `indexer canonical` on the first file as processes
    beside it. The index is then served through main.build_searcher with the
    dual encoder in recall: each of INDEX_SAMPLED pages' own title token
    finds it at rank 1, a round of 2- and 3-term queries launches K1-K3, and
    their top-10s match the plain versions'. Launches counted from 0 over
    the build and over the round. → the phase's record."""
    import numpy as np
    import torch

    from stract_tpu_torch import warc_corpus as WC
    from stract_tpu_torch.entrypoint import indexer as IX
    from stract_tpu_torch.entrypoint.centrality import run_harmonic
    from stract_tpu_torch.entrypoint.webgraph_build import build_from_warcs
    from stract_tpu_torch.index.inverted import InvertedIndex
    from stract_tpu_torch.kv import Db
    from stract_tpu_torch.main import build_searcher
    from stract_tpu_torch.models.dual_encoder import DualEncoder
    from stract_tpu_torch.ops import kernels
    from stract_tpu_torch.searcher.query import SearchQuery
    from stract_tpu_torch.tokenizer.stemmer import stem

    stemmed = stem("running")
    log(f"[index] the port's stemmer: stem('running') = {stemmed!r}")
    if stemmed != "run":
        raise AssertionError(f"the stemmer is not live: stem('running') = {stemmed!r}")
    root = os.path.join(data_dir, "index_build")
    shutil.rmtree(root, ignore_errors=True)
    out_dir, graph_dir, cent_dir = (os.path.join(root, n) for n in ("index", "graph", "cent"))
    t_phase = t = time.perf_counter()
    info = WC.write_warcs(os.path.join(root, "warc"), files=INDEX_FILES, pages=INDEX_PAGES,
                          seed=SEED, hosts=INDEX_HOSTS)
    secs = {"warc": time.perf_counter() - t}
    procs = {}
    for action in ("search", "canonical"):
        cfg = os.path.join(root, f"{action}.toml")
        with open(cfg, "w") as fh:
            fh.write(f'warc_paths = ["{info.paths[0]}"]\n'
                     f'output_path = "{os.path.join(root, "cli_" + action)}"\n')
        procs[action] = subprocess.Popen(
            [sys.executable, "-m", "stract_tpu_torch.main", "indexer", action, cfg], cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        dual = DualEncoder.load(dual_dir, device=DEVICE)
        embed_s, commit_s, merge_s, pre, stored = [], [], [], [], {}
        real_attach = IX.IndexingWorker.attach_embeddings
        real_commit, real_merge = InvertedIndex.commit, InvertedIndex.merge_all

        def attach(self, docs):
            t0 = time.perf_counter()
            real_attach(self, docs)
            embed_s.append(time.perf_counter() - t0)
            stored.update((d["url"], d["title_embedding"]) for d in docs)

        def commit(self):
            t0 = time.perf_counter()
            real_commit(self)
            commit_s.append(time.perf_counter() - t0)
            seg = self.segments[-1]
            pre.append((seg.num_docs, np.array(seg.term_hashes), seg.meta["num_postings"],
                        len(seg.stored_offsets) - 1))

        def merge_all(self):
            t0 = time.perf_counter()
            real_merge(self)
            merge_s.append(time.perf_counter() - t0)

        kernels.reset_launches()
        t = time.perf_counter()
        build_from_warcs(info.paths, graph_dir, level="host")
        secs["graph"] = time.perf_counter() - t
        t = time.perf_counter()
        run_harmonic(graph_dir, cent_dir, device=DEVICE)
        torch.cuda.synchronize()
        secs["centrality"] = time.perf_counter() - t
        worker = IX.IndexingWorker(host_centrality=Db.open(cent_dir), dual_encoder=dual)
        IX.IndexingWorker.attach_embeddings = attach
        InvertedIndex.commit, InvertedIndex.merge_all = commit, merge_all
        t = time.perf_counter()
        try:
            index = IX.run(info.paths, out_dir, worker, embedding_dim=dual.embedding_dim,
                           device=DEVICE)
        finally:
            IX.IndexingWorker.attach_embeddings = real_attach
            InvertedIndex.commit, InvertedIndex.merge_all = real_commit, real_merge
        secs["indexer"] = time.perf_counter() - t
        build_launches = dict(kernels.LAUNCHES)
        secs.update(embedding=sum(embed_s), commit=sum(commit_s), merge=sum(merge_s))
        secs["parse_index"] = secs["indexer"] - secs["embedding"] - secs["commit"] - secs["merge"]
        missing = [k for k in INDEX_BUILD_KERNELS if build_launches[k] == 0]
        if missing:
            raise AssertionError(f"the build launched no {missing}: {build_launches}")

        # ---- what the build wrote ---------------------------------------------------
        docs = info.pages - info.noindex
        seg = index.segments[0]
        if index.num_docs != docs or len(pre) != INDEX_FILES or len(index.segments) != 1:
            raise AssertionError(f"{index.num_docs} docs in {len(index.segments)} segments "
                                 f"from {len(pre)} commits; {docs} pages to index")
        want = (sum(p[0] for p in pre), len(np.unique(np.concatenate([p[1] for p in pre]))),
                sum(p[2] for p in pre), sum(p[3] for p in pre))
        got = (seg.num_docs, seg.meta["num_terms"], seg.meta["num_postings"],
               len(seg.stored_offsets) - 1)
        if got != want:
            raise AssertionError(f"merged (docs, terms, postings, stored) {got} != {want}")
        emb = np.asarray(seg.embeddings("title_embeddings"))
        urls = [seg.stored_doc(d)["url"] for d in range(seg.num_docs)]
        store_err = max(float(np.abs(emb[d].astype(np.float32) - np.asarray(
            stored[u], np.float16).astype(np.float32)).max()) for d, u in enumerate(urls))
        if store_err != 0.0:
            raise AssertionError(f"stored title embeddings differ from embed(): {store_err}")
        titles = [seg.stored_doc(d)["title"] for d in range(256)]
        fresh_err = float(np.abs(dual.embed(titles) - emb[:256].astype(np.float32)).max())
        if fresh_err > 2e-2 + 1e-3:
            raise AssertionError(f"title embeddings re-embedded differ by {fresh_err}")

        # ---- serve it on the card, the dual encoder in recall ----------------------------
        t = time.perf_counter()
        searcher = build_searcher(out_dir, DEVICE, dual_encoder=dual_dir)
        rng = np.random.default_rng(SEED + 26)
        sampled = [urls[d] for d in rng.choice(len(urls), INDEX_SAMPLED, replace=False)]
        for url in sampled:
            page = searcher.search(SearchQuery.from_json({"query": info.unique[url]})).to_json()
            if not page["webpages"] or page["webpages"][0]["url"] != url:
                raise AssertionError(f"{info.unique[url]} does not find {url} at rank 1: "
                                     f"{[w['url'] for w in page['webpages'][:3]]}")
        bodies = index_bodies(seg, rng)
        kernels.reset_launches()
        t1 = time.perf_counter()
        hits = sum(len(searcher.search(SearchQuery.from_json(b)).to_json()["webpages"])
                   for b in bodies)
        round_s = time.perf_counter() - t1
        serve_launches = dict(kernels.LAUNCHES)
        if hits == 0 or any(serve_launches[k] == 0 for k in SCORING):
            raise AssertionError(f"the round's {hits} results launched {serve_launches}")
        cmp = compare_phase(searcher, bodies=[{"query": b["query"]} for b in bodies])
        secs["serve"] = time.perf_counter() - t
        del searcher

        # ---- the command line's processes --------------------------------------------
        t = time.perf_counter()
        cli = {}
        for action, proc in procs.items():
            out, _ = proc.communicate(timeout=600)
            if proc.returncode != 0:
                raise AssertionError(f"main.py indexer {action} exited {proc.returncode}: "
                                     f"{out[-2000:]}")
            cli[action] = out.strip().splitlines()[-1]
        secs["cli_wait"] = time.perf_counter() - t
        cli_docs = InvertedIndex(os.path.join(root, "cli_search"), "cpu").num_docs
        if cli_docs != pre[0][0]:
            raise AssertionError(f"main.py indexer search indexed {cli_docs} docs, not "
                                 f"{pre[0][0]}")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    secs["phase"] = time.perf_counter() - t_phase
    return {"pages": info.pages, "noindex": info.noindex, "docs": seg.num_docs,
            "segments_before_merge": len(pre), "terms": seg.meta["num_terms"],
            "postings": seg.meta["num_postings"], "seconds": secs,
            "pages_per_s": info.pages / secs["indexer"], "build_launches": build_launches,
            "serve_launches": serve_launches, "round_queries": len(bodies),
            "round_s": round_s, "sampled_rank1": len(sampled), "store_err": store_err,
            "reembed_err": fresh_err, "vs_plain": cmp, "cli": cli, "stem": stemmed}


def index_line(rec: dict, card: str) -> str:
    """The `[result index]` line of index_phase's record."""
    secs = " ".join(f"{k}_s={v:.2f}" for k, v in rec["seconds"].items())
    k5 = {k: rec["build_launches"][k] for k in ("attention", "add_layernorm", "bias_gelu",
                                                 "mean_pool")}
    k6 = {k: rec["build_launches"][k] for k in ("hll_merge", "hll_estimate")}
    k13 = {k: rec["serve_launches"][k] for k in SCORING}
    return (f"[result index] pages={rec['pages']} noindex={rec['noindex']} docs={rec['docs']} "
            f"segments={rec['segments_before_merge']}->1 terms={rec['terms']} postings="
            f"{rec['postings']} {secs} pages_per_s={rec['pages_per_s']:.1f} "
            f"k5_launches={json.dumps(k5)} k6_launches={json.dumps(k6)} k1_k3_launches="
            f"{json.dumps(k13)} round={rec['round_queries']} queries in {rec['round_s']:.2f}s "
            f"rank1={rec['sampled_rank1']}/{INDEX_SAMPLED} store_err={rec['store_err']} "
            f"reembed_err={rec['reembed_err']:.3g} vs_plain={json.dumps(rec['vs_plain'])} "
            f"stem={rec['stem']!r} cli={json.dumps(rec['cli'])} card={card}")


# ---- the freshness tier: a fake web, the live crawler, two live replicas ----------------
class FakeWeb:
    """LIVE_SITES seeded sites of LIVE_SITE_PAGES pages (warc_corpus.page under
    LIVE_SEED), served by an http.server on 127.0.0.1 in a thread. A page is
    published at its seeded time of the simulated clock `now[0]` (most
    before the crawl starts, the rest over LIVE_HOURS): each site's feed (RSS
    2.0 or Atom, half each) lists its LIVE_FEED_ITEMS latest pages, its
    sitemap every published page (every fifth site a sitemapindex over two
    urlsets; a raw `&` in every seventh loc), its front page the latest
    LIVE_FRONT_LINKS, and its robots.txt disallows one page. fetch() maps
    https://{site}/... to the loopback server over a kept-alive HTTP/1.1
    connection a thread, so nothing leaves the machine."""

    def __init__(self, now: list, t0: float):
        import re
        import threading

        import numpy as np

        from stract_tpu_torch import warc_corpus as WC

        self.now = now
        rng = np.random.default_rng(LIVE_SEED)
        self.sites = [f"live{s}.example" for s in range(LIVE_SITES)]
        self.pages = {}  # site → [(path, html, title, published)]
        for s, site in enumerate(self.sites):
            rows = []
            for k in range(LIVE_SITE_PAGES):
                url, html, _ = WC.page(rng, LIVE_SEED, 1 + s * LIVE_SITE_PAGES + k, [site],
                                       words=LIVE_WORDS)
                title = re.search(r"<title>(.*?)</title>", html).group(1)
                published = (t0 - 1.0 if rng.random() < LIVE_BACKLOG
                             else t0 + float(rng.uniform(0, LIVE_HOURS * 3600)))
                rows.append((url.split(site, 1)[1], html, title, published))
            self.pages[site] = rows
        self.fetched: list = []
        self.server = self.thread = None
        self._conns = threading.local()

    def disallowed(self, site: str) -> str:
        return self.pages[site][-1][0]

    def published(self, site: str) -> list:
        return sorted((p for p in self.pages[site] if p[3] <= self.now[0]), key=lambda p: p[3])

    def body(self, site: str, path: str) -> tuple:
        """(status, text) of https://{site}{path} at the simulated time."""
        from xml.sax.saxutils import escape

        if site not in self.pages:
            return 404, ""
        pub = self.published(site)
        s = self.sites.index(site)
        base = f"https://{site}"
        if path == "/robots.txt":
            return 200, f"User-agent: *\nDisallow: {self.disallowed(site)}\n"
        if path == "/":
            links = "".join(f'<a href="{p[0]}">{escape(p[2])}</a>'
                            for p in pub[-LIVE_FRONT_LINKS:])
            return 200, f"<html><head><title>{site}</title></head><body>{links}</body></html>"
        if path == "/feed.xml":
            latest = pub[-LIVE_FEED_ITEMS:][::-1]
            if s % 2 == 0:
                items = "".join(f"<item><title>{escape(p[2])}</title><link>{base}{p[0]}</link>"
                                f"<pubDate>{p[3]:.0f}</pubDate></item>" for p in latest)
                return 200, (f'<?xml version="1.0"?><rss version="2.0"><channel><title>{site}'
                             f"</title>{items}</channel></rss>")
            entries = "".join(f'<entry><title>{escape(p[2])}</title><link rel="alternate" '
                              f'href="{base}{p[0]}"/><updated>{p[3]:.0f}</updated></entry>'
                              for p in latest)
            return 200, (f'<feed xmlns="http://www.w3.org/2005/Atom"><title>{site}</title>'
                         f"{entries}</feed>")
        locs = [base + p[0] + ("?src=sitemap&utm=1" if k % 7 == 3 else "")
                for k, p in enumerate(pub)]
        urlset = lambda ls: ('<urlset xmlns="http://www.sitemaps.org/schemas/sitemap/0.9">'  # noqa: E731
                             + "".join(f"<url><loc>{u}</loc></url>" for u in ls) + "</urlset>")
        if path == "/sitemap.xml":
            if s % 5 == 0:
                return 200, ("<sitemapindex>" + "".join(
                    f"<sitemap><loc>{base}/sitemap-{k}.xml</loc></sitemap>" for k in (0, 1))
                    + "</sitemapindex>")
            return 200, urlset(locs)
        if path in ("/sitemap-0.xml", "/sitemap-1.xml"):
            return 200, urlset(locs[int(path[9])::2])
        for p in pub:
            if p[0] == path:
                return 200, p[1]
        return 404, ""

    def start(self):
        import threading
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        web = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"  # keep-alive: one connection a crawler thread
            disable_nagle_algorithm = True  # headers and body go out as they are written

            def do_GET(self):
                site, _, rest = self.path.lstrip("/").partition("/")
                status, text = web.body(site, "/" + rest.split("?", 1)[0])
                data = text.encode()
                self.send_response(status)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def log_message(self, *a):
                pass

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()
        return self

    def fetch(self, url: str, timeout: float = 30.0):
        """The crawlers' fetch_fn: https://{site}{path} → (status, body, ms)
        from the loopback server (the form of crawler/worker.py
        default_fetch; any failure is status 0)."""
        import http.client

        self.fetched.append(url)
        t = time.perf_counter()
        for _ in range(2):  # a dropped kept-alive connection: one new one
            conn = getattr(self._conns, "conn", None)
            if conn is None:
                conn = self._conns.conn = http.client.HTTPConnection(
                    "127.0.0.1", self.server.server_address[1], timeout=timeout)
            try:
                conn.request("GET", "/" + url.split("://", 1)[1])
                resp = conn.getresponse()
                body = resp.read().decode("utf-8", errors="replace")
                return resp.status, body, int((time.perf_counter() - t) * 1000)
            except (OSError, http.client.HTTPException):
                conn.close()
                self._conns.conn = None
        return 0, "", int((time.perf_counter() - t) * 1000)

    def stop(self):
        if self.server is not None:
            self.server.shutdown()
            self.server.server_close()
            self.thread.join(timeout=30)


def cuda_tensors() -> dict:
    """{(shape, dtype): count} of the CUDA tensors the garbage collector
    reaches: what a growth of card memory is made of."""
    import collections
    import gc

    import torch

    out = collections.Counter()
    for o in gc.get_objects():
        try:
            if torch.is_tensor(o) and o.is_cuda:
                out[(tuple(o.shape), str(o.dtype))] += 1
        except Exception:  # noqa: BLE001 — an object that fails isinstance checks is no tensor
            continue
    return out


def segment_device_bytes(index) -> int:
    """The card bytes of the largest of the index's device copies."""
    import torch

    best = 0
    for dev in list(index._device.values()):
        best = max(best, sum(t.numel() * t.element_size() for t in dev.arrays
                             if torch.is_tensor(t)))
    return best


def live_check(replica, cpu_root: str, clock, queries: list, stage: str) -> dict:
    """Each query's top 10 from live replica 0 over sonic (its search on the
    card) against the same search on a device="cpu" LiveIndex opened on a
    copy of the replica's directory: docs equal up to ties at the cut, scores
    within LIVE_TOL. → the largest score difference and the hits."""
    import numpy as np

    from stract_tpu_torch.distributed.sonic import RemoteClient
    from stract_tpu_torch.entrypoint.search_server import candidate_to_wire
    from stract_tpu_torch.live_index import LiveIndex
    from stract_tpu_torch.searcher.local import LocalSearcher
    from stract_tpu_torch.searcher.query import SearchQuery

    live = replica["service"].live
    copy = os.path.join(cpu_root, stage)
    shutil.rmtree(copy, ignore_errors=True)
    shutil.copytree(live.path, copy)
    cpu = LiveIndex(copy, device="cpu", clock=clock)
    if cpu.index.meta["segments"] != live.index.meta["segments"]:
        raise AssertionError(f"[live {stage}] the copy opened other segments")
    cpu_search = LocalSearcher(cpu.index, shard_id=0, lazy_signals=False)
    client = RemoteClient(replica["server"].addr, timeout=120)
    names = list(live.index.meta["segments"])
    err, hits = 0.0, 0

    def top10(cands):
        cands = sorted(cands, key=lambda c: -c[1])[:10]
        keys = np.array([names.index(s) << 32 | d for (s, d), _ in cands], dtype=np.int64)
        return keys, np.array([sc for _, sc in cands], dtype=np.float64)

    for q in queries:
        sq = SearchQuery.from_json({"query": q})
        card = [((c["seg"], c["doc"]), c["score"])
                for c in client.send("search", sq.to_json())["candidates"]]
        plain = [((w["seg"], w["doc"]), w["score"]) for w in
                 map(candidate_to_wire, cpu_search.search_initial(sq)[0])]
        ka, sa = top10(card)
        kb, sb = top10(plain)
        if len(ka) != len(kb):
            raise AssertionError(f"[live {stage}] {q!r}: {len(ka)} results on the card, "
                                 f"{len(kb)} on the cpu")
        err = max(err, topk_match(ka, sa, kb, sb, -1, *LIVE_TOL))
        hits += len(ka)
    cpu.wal.close()
    return {"max_score_diff": err, "hits": hits}


def live_phase(data_dir: str, card: str) -> dict:
    """The freshness tier on the card: a FakeWeb of LIVE_SITES sites on
    127.0.0.1; two live-index replicas of shard 0 (entrypoint/live_index.py
    run on the card, over sonic, joined by gossip to a search shard over the
    index phase's index); a LiveCrawler with a crawled-URLs Db ticking over
    the sites every 10 simulated minutes for LIVE_HOURS hours and pushing its
    batches through LiveIndexClient(consistency_fraction=0.5), each replica's
    tick() between crawls (autocommit, hourly compaction, the TTL); the
    coordinator (entrypoint/api.py over gossip) and its HTTP route in front.
    Before compaction, after it and after a jump past the 60-day TTL: 64
    queries over HTTP, each page holding a live candidate (shard >=
    LIVE_SHARD_OFFSET), and 64 queries' top 10 from replica 0 against a CPU
    LiveIndex on a copy of its directory. Card memory after the last
    compaction-and-prune cycle within one segment's device copy of the
    first's; a quorum write at fraction 0.5 with a replica down acks, at 1.0
    raises; `main.py live-index serve` as a process answers a search found by
    gossip; the crawl roles (coordinator, router, worker over sonic) crawl
    LIVE_ROLE_SITES sites into WARC files, robots obeyed. K1-K3 launches of
    the live shards' own searches, counted from 0 around them. → record."""
    import gc

    import numpy as np
    import torch

    from stract_tpu_torch.config import ApiConfig
    from stract_tpu_torch.crawler import CrawlCoordinator, Job, Router
    from stract_tpu_torch.crawler.worker import WorkerThread
    from stract_tpu_torch.distributed.cluster import Cluster, Service
    from stract_tpu_torch.distributed.replication import ReplicatedClient
    from stract_tpu_torch.distributed.sonic import RemoteClient, RpcError, serve_in_thread
    from stract_tpu_torch.entrypoint import live_index as LE
    from stract_tpu_torch.entrypoint import search_server
    from stract_tpu_torch.entrypoint.api import build_coordinator, coordinator_app
    from stract_tpu_torch.kv import Db
    from stract_tpu_torch.live_index import LiveCrawler
    from stract_tpu_torch.live_index.index import TTL_SECONDS
    from stract_tpu_torch.main import ServerThread
    from stract_tpu_torch.ops import kernels
    from stract_tpu_torch.searcher.distributed import LIVE_SHARD_OFFSET
    from stract_tpu_torch.warc import WarcReader, WarcWriter

    root = os.path.join(data_dir, "live")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    t_phase = time.perf_counter()
    t0 = NOW
    now = [t0]
    clock = lambda: now[0]  # noqa: E731
    web = FakeWeb(now, t0).start()
    secs = {k: 0.0 for k in ("crawl", "insert", "commit", "compact", "tick", "search", "http",
                             "roles", "cli")}
    clusters, servers, api_cluster, http, cli_proc = [], [], None, None, None
    backbone_svc = None
    rec = {"segments": {}}
    try:
        # ---- the backbone shard, two live replicas, the coordinator --------------------
        backbone = os.path.join(data_dir, "index_build", "index")
        bsrv, bcl = search_server.run(backbone, 0, device=DEVICE, mesh="off")
        backbone_svc = bsrv.server.service
        servers.append(bsrv)
        clusters.append(bcl)
        seed = [f"{bcl.gossip_addr[0]}:{bcl.gossip_addr[1]}"]
        replicas = []
        for r in range(2):
            srv, cl = LE.run(os.path.join(root, f"replica{r}"), 0, device=DEVICE, clock=clock,
                             gossip_seeds=[tuple(bcl.gossip_addr)])
            servers.append(srv)
            clusters.append(cl)
            replicas.append({"server": srv, "cluster": cl, "service": srv.server.service})
        for rep in replicas:  # time the replicas' commits and compactions
            live = rep["service"].live
            for name in ("commit", "compact"):
                def timed(fn=getattr(live, name), name=name):
                    t = time.perf_counter()
                    fn()
                    secs[name] += time.perf_counter() - t
                setattr(live, name, timed)
        cli_dir = os.path.join(root, "cli")
        with open(os.path.join(root, "cli.toml"), "w") as fh:
            fh.write(f'path = "{cli_dir}"\nshard = {LIVE_CLI_SHARD}\nhost = "127.0.0.1"\n'
                     f'[gossip]\naddr = "127.0.0.1:0"\nseeds = ["{seed[0]}"]\n')
        cli_proc = subprocess.Popen(
            [sys.executable, "-m", "stract_tpu_torch.main", "live-index", "serve",
             os.path.join(root, "cli.toml"), "--device", DEVICE], cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        cfg = ApiConfig(gossip={"addr": "127.0.0.1:0", "seeds": seed})
        api, api_cluster, pages = build_coordinator(cfg, DEVICE)
        for want in ("search-server", "live-index"):
            if api_cluster.await_member(lambda m: m.service.kind == want, timeout=60) is None:
                raise AssertionError(f"the coordinator did not find a {want}")
        if not api_cluster.await_member(
                lambda m: m.service.kind == "live-index" and m.service.host == tuple(
                    replicas[1]["server"].addr), timeout=60):
            raise AssertionError("the coordinator did not find the second replica")
        http = ServerThread(coordinator_app(cfg, api, pages))
        dist = api.searcher
        page_shards, placeholders = {}, {}  # query → its page's shards; its empty docs
        real_retrieve = dist.retrieve

        def retrieve(sq, candidates):
            page_shards.setdefault(sq.query, []).extend(int(c.shard) for c in candidates)
            real_retrieve(sq, candidates)
            placeholders[sq.query] = placeholders.get(sq.query, 0) + sum(
                not c.retrieved and c.shard >= LIVE_SHARD_OFFSET for c in candidates)
        dist.retrieve = retrieve

        # ---- the crawl: LIVE_HOURS simulated hours, a tick every 10 minutes ---------------
        client = LE.LiveIndexClient(ReplicatedClient([r["server"].addr for r in replicas],
                                                     timeout=600), consistency_fraction=0.5)
        indexed = [0]

        def index_fn(batch):
            t = time.perf_counter()
            indexed[0] += client.index_webpages([{"url": u, "html": h} for u, h in batch])
            secs["insert"] += time.perf_counter() - t

        crawled = Db.open(os.path.join(root, "db"))
        crawler = LiveCrawler(web.fetch, index_fn, crawled_db=crawled, clock=clock)
        for site in web.sites:
            crawler.add_site(site, feeds=[f"https://{site}/feed.xml"],
                             sitemaps=[f"https://{site}/sitemap.xml"])
        checks, mem = {}, {}
        rng_q = np.random.default_rng(LIVE_SEED + 2)

        def segments() -> list:
            return [len(r["service"].live.index.segments) for r in replicas]

        def queries() -> tuple:
            """64 HTTP queries from the indexed live pages' titles (a title
            word and the title's own token) and 64 for the top-10 check
            (title-word pairs, stop-word pairs: the scan path and pass 2)."""
            live = replicas[0]["service"].live
            titles = [seg.stored_doc(d)["title"] for seg in live.index.segments
                      for d in range(seg.num_docs)]
            if not titles:
                raise AssertionError("the live replica holds no docs")
            picks = rng_q.choice(len(titles), LIVE_QUERIES, replace=len(titles) < LIVE_QUERIES)
            http_q = [" ".join(titles[i].split()[:1] + titles[i].split()[-1:]) for i in picks]
            words = [titles[i].split()[:-1] for i in picks]
            stops = ("the and", "of to", "in is", "the of", "and a", "for with", "to the",
                     "is that")
            check_q = [" ".join(w[:2]) if len(w) > 1 else w[0] for w in words[:48]]
            check_q += [stops[k % len(stops)] for k in range(LIVE_QUERIES - len(check_q))]
            return http_q, check_q

        def checkpoint(stage: str):
            t = time.perf_counter()
            http_q, check_q = queries()
            kernels.reset_launches()
            res = live_check(replicas[0], os.path.join(root, "cpu"), clock, check_q, stage)
            launches = {k: kernels.LAUNCHES[k] for k in SCORING}
            secs["search"] += time.perf_counter() - t
            t = time.perf_counter()
            page_shards.clear()
            placeholders.clear()
            with ThreadPoolExecutor(CLIENTS) as pool:
                answers = list(pool.map(lambda q: post(http.url + "/beta/api/search",
                                                       {"query": q}), http_q))
            secs["http"] += time.perf_counter() - t
            no_live, live_urls = [], 0
            for q, (status, data, _) in zip(http_q, answers):
                if status != 200 or data.get("type") != "websites":
                    raise AssertionError(f"[live {stage}] {q!r}: {status} {str(data)[:200]}")
                shards = page_shards.get(q, [])
                if not any(s >= LIVE_SHARD_OFFSET for s in shards):
                    no_live.append(q)
                live_urls += any(".example/" in w.get("url", "") for w in data["webpages"])
            if no_live:
                raise AssertionError(f"[live {stage}] {len(no_live)} of {len(http_q)} pages hold "
                                     f"no live result, the first {no_live[0]!r}")
            empty = sum(placeholders.values())
            checks[stage] = {**res, "segments": segments(), "launches": launches,
                             "pages_with_a_live_url": live_urls, "live_placeholders": empty,
                             "http_queries": len(http_q)}
            log(f"[live {stage}] segments={segments()} docs="
                f"{replicas[0]['service'].live.index.num_docs} top10_vs_cpu_max_score_diff="
                f"{res['max_score_diff']:.3g} hits={res['hits']} pages_with_a_live_url="
                f"{live_urls}/{len(http_q)} live_placeholders={empty} "
                f"replica0_launches={json.dumps(launches)} card={card}")

        def replica_ticks():
            t = time.perf_counter()
            for r in replicas:
                RemoteClient(r["server"].addr, timeout=600).send("tick", None)
            secs["tick"] += time.perf_counter() - t

        tensors = {}

        def memory(point: str) -> int:
            gc.collect()
            if DEVICE != "cuda":
                return 0
            torch.cuda.synchronize()
            tensors[point] = cuda_tensors()
            return torch.cuda.memory_allocated()

        seg_bytes = 0
        for step in range(LIVE_HOURS * 6):
            now[0] = t0 + 600.0 * step
            t = time.perf_counter()
            crawler.tick()
            if step % 6 == 5:
                # the crawled-URL store gains a segment a tick (LiveCrawler
                # commits it and never merges, as in the JAX package) and a
                # lookup reads every segment: merged hourly here
                crawled.merge_segments()
            secs["crawl"] += time.perf_counter() - t
            replica_ticks()
            if step % 6 == 0:
                rec["segments"][f"hour {step // 6}"] = segments()
            if step == 5:
                checkpoint("before compaction")
                seg_bytes = max(segment_device_bytes(r["service"].live.index) for r in replicas)
            if step == 6:
                mem["first"] = memory("first")
                checkpoint("after compaction")
            if step % 36 == 35:
                log(f"[live hour {(step + 1) // 6}] segments={segments()} "
                    f"seconds={json.dumps({k: round(v, 2) for k, v in secs.items()})}")
        secs["crawl"] -= secs["insert"]
        rec["segments"]["end"] = segments()
        # a jump past the TTL: the first LIVE_PRUNED_HOURS hours' segments drop
        now[0] = t0 + TTL_SECONDS + LIVE_PRUNED_HOURS * 3600.0
        before = segments()
        replica_ticks()
        mem["last"] = memory("last")
        rec["segments"]["after the ttl"] = segments()
        if not all(a < b for a, b in zip(segments(), before)):
            raise AssertionError(f"the TTL dropped no segment: {before} -> {segments()}")
        checkpoint("after the prune")
        if mem["last"] > mem["first"] + seg_bytes:
            grown = tensors["last"] - tensors["first"]
            raise AssertionError(f"card memory grew across compactions: {mem['last']} bytes "
                                 f"after the last cycle, {mem['first']} after the first, one "
                                 f"segment {seg_bytes}; CUDA tensors the collector reaches "
                                 f"added: {sorted(grown.items(), key=lambda kv: -kv[1])[:12]}")
        launches = {k: sum(c["launches"][k] for c in checks.values()) for k in SCORING}
        if DEVICE == "cuda" and any(v == 0 for v in launches.values()):
            raise AssertionError(f"the live shards' searches launched {launches}")
        docs = replicas[0]["service"].live.index.num_docs
        if docs != replicas[1]["service"].live.index.num_docs:
            raise AssertionError("the replicas hold different counts of docs")

        # ---- a quorum with one replica down ---------------------------------------------
        dist.retrieve = real_retrieve
        http.stop()
        http = None
        api.searcher.client.close()
        api.searcher.live_client.close()
        replicas[1]["cluster"].shutdown()
        clusters.remove(replicas[1]["cluster"])
        replicas[1]["server"].stop()
        servers.remove(replicas[1]["server"])
        addrs = [r["server"].addr for r in replicas]
        one = [{"url": f"https://{web.sites[0]}/quorum", "html": web.pages[web.sites[0]][0][1]}]
        acked = LE.LiveIndexClient(ReplicatedClient(addrs, timeout=30), 0.5).index_webpages(one)
        try:
            LE.LiveIndexClient(ReplicatedClient(addrs, timeout=30), 1.0).index_webpages(one)
            raise AssertionError("a write at fraction 1.0 acked with a replica down")
        except RpcError as e:
            quorum = {"fraction_0.5_acked": acked, "fraction_1.0": str(e)}

        # ---- main.py live-index serve as a process ----------------------------------------
        t = time.perf_counter()
        m = api_cluster.await_member(lambda m: m.service.kind == "live-index"
                                     and m.service.shard == LIVE_CLI_SHARD, timeout=300)
        if m is None:
            raise AssertionError("main.py live-index serve did not join gossip: "
                                 + (cli_proc.stdout.read() if cli_proc.poll() is not None
                                    else "still running"))
        cli = RemoteClient(tuple(m.service.host), timeout=300)
        pages3 = [{"url": f"https://{s}{p[0]}", "html": p[1]}
                  for s in web.sites[:3] for p in web.pages[s][:2]]
        cli.send("index_webpages", {"pages": pages3})
        cli.send("commit", None)
        title = web.pages[web.sites[0]][0][2]
        found = cli.send("search", {"query": title.split()[-1]})
        if not found["candidates"]:
            raise AssertionError(f"main.py live-index serve found nothing for {title!r}")
        secs["cli"] = time.perf_counter() - t

        # ---- the crawl roles over sonic ------------------------------------------------------
        t = time.perf_counter()
        crawl_root = os.path.join(root, "crawl")
        coord = CrawlCoordinator(os.path.join(crawl_root, "jobs"),
                                 os.path.join(crawl_root, "discovered"))
        role_sites = web.sites[:LIVE_ROLE_SITES]
        coord.add_jobs([Job(site, [f"https://{site}{p[0]}" for p in web.pages[site]])
                        for site in role_sites])
        csrv = serve_in_thread(coord)
        servers.append(csrv)
        rsrv = serve_in_thread(Router([csrv.addr]))
        servers.append(rsrv)
        os.makedirs(os.path.join(crawl_root, "warc"))
        web.fetched.clear()
        done = WorkerThread(RemoteClient(rsrv.addr, timeout=600), fetch_fn=web.fetch,
                            warc_factory=lambda d: WarcWriter.open(
                                os.path.join(crawl_root, "warc", d + ".warc.gz")),
                            sleep_fn=lambda s: None).run()
        records = {}
        for site in role_sites:
            reader = WarcReader.open(os.path.join(crawl_root, "warc", site + ".warc.gz"))
            records[site] = sorted(r.url for r in reader)
            reader.fileobj.close()
        for site in role_sites:
            bad = f"https://{site}{web.disallowed(site)}"
            if bad in web.fetched:
                raise AssertionError(f"the worker fetched {bad}, which robots.txt disallows")
            allowed = sorted(f"https://{site}{p[0]}" for p in web.pages[site][:-1])
            if records[site] != allowed:
                raise AssertionError(f"{site}: {len(records[site])} WARC records, "
                                     f"{len(allowed)} pages allowed")
        secs["roles"] = time.perf_counter() - t
        rec.update(
            sites=LIVE_SITES, pages=LIVE_SITES * LIVE_SITE_PAGES, indexed=indexed[0],
            docs=docs, checks=checks, launches=launches, memory=mem,
            segment_device_bytes=seg_bytes, quorum=quorum, cli_candidates=len(found["candidates"]),
            role_jobs=done, role_records=sum(len(v) for v in records.values()),
            fetches=len(web.fetched), seconds=secs)
    finally:
        if http is not None:
            http.stop()
        if api_cluster is not None:
            api.searcher.client.close()
            api.searcher.live_client.close()
            api_cluster.shutdown()
        if cli_proc is not None:
            cli_proc.terminate()
            try:
                cli_proc.communicate(timeout=30)
            except subprocess.TimeoutExpired:
                cli_proc.kill()
                cli_proc.communicate(timeout=30)
        for cl in clusters:
            cl.shutdown()
        for srv in servers:
            srv.stop()
        if backbone_svc is not None and backbone_svc.searcher.batcher is not None:
            backbone_svc.searcher.batcher.stop()
        web.stop()
    rec["seconds"]["phase"] = time.perf_counter() - t_phase
    return rec


def live_line(rec: dict, card: str) -> str:
    """The `[result live]` line of live_phase's record."""
    secs = " ".join(f"{k}_s={v:.2f}" for k, v in rec["seconds"].items())
    checks = {k: {"max_score_diff": v["max_score_diff"], "hits": v["hits"],
                  "segments": v["segments"], "pages_with_a_live_url": v["pages_with_a_live_url"],
                  "live_placeholders": v["live_placeholders"]} for k, v in rec["checks"].items()}
    return (f"[result live] sites={rec['sites']} pages={rec['pages']} indexed={rec['indexed']} "
            f"docs={rec['docs']} {secs} segments={json.dumps(rec['segments'])} checks="
            f"{json.dumps(checks)} k1_k3_launches={json.dumps(rec['launches'])} memory_bytes="
            f"{json.dumps(rec['memory'])} one_segment_bytes={rec['segment_device_bytes']} "
            f"quorum={json.dumps(rec['quorum'])} cli_candidates={rec['cli_candidates']} "
            f"roles={rec['role_jobs']} jobs {rec['role_records']} records fetches="
            f"{rec['fetches']} card={card}")


def models_phase(searcher, index_dir: str, out_dir: str) -> dict:
    """Tokenizer, MiniLM dual and cross encoders trained on the card (the
    train phase), and a forest trained on pipeline-off signal rows, saved
    through the port's writers. → the train phase's record plus {"forest":
    path, "rows": the forest's training matrix, "seconds"}."""
    import numpy as np

    from stract_tpu_torch import bench_corpus as bc
    from stract_tpu_torch.models.wordpiece import WordPieceTokenizer
    from stract_tpu_torch.ranking.models.lambdamart import LambdaMART, signal_matrix
    from stract_tpu_torch.searcher.query import SearchQuery

    t0 = time.perf_counter()
    seg = searcher.searcher.searchers[0].index.segments[0]
    rng = np.random.default_rng(SEED + 2)
    texts = []
    for d in rng.choice(seg.num_docs, size=min(TOK_DOCS, seg.num_docs), replace=False):
        stored = seg.stored_doc(int(d))
        texts.append(stored["title"] + " " + stored["clean_text"])
    texts += bc.sample_queries(rng, 2000)
    tok = WordPieceTokenizer.build(texts, vocab_size=VOCAB)
    log(f"[models] vocab of {len(tok.vocab)} pieces in {time.perf_counter() - t0:.1f}s")
    trained = train_phase(index_dir, out_dir, tok)
    forest_path = os.path.join(out_dir, "lambdamart.json")

    X, y = [], []
    for q in bc.sample_queries(np.random.default_rng(SEED + 3), FOREST_QUERIES):
        page = searcher.search(SearchQuery.from_json(
            {"query": q, "numResults": 20, "returnRankingSignals": True})).to_json()
        X.append(signal_matrix(page["webpages"]))
        for w in page["webpages"]:  # graded by title containment, as the bench's trainer
            hits = sum(t in w["title"].split() for t in q.split())
            y.append(2.0 ** (3.0 if hits == 2 else 2.0 if hits else 1.0) - 1.0)
    X = np.concatenate(X)[:2000]
    t1 = time.perf_counter()
    forest = LambdaMART.train(X, np.asarray(y)[:2000], num_trees=40, max_depth=3)
    with open(forest_path, "w") as fh:
        fh.write(forest.to_json())
    log(f"[models] forest of {forest.num_trees} trees on {len(X)} rows in "
        f"{time.perf_counter() - t1:.1f}s")
    return {**trained, "forest": forest_path, "rows": X, "seconds": time.perf_counter() - t0}


def model_kernel_phase(forest, rows) -> list:
    """K4 and K5a-c against their plain versions at the pipeline's shapes:
    the forest at K in FOREST_K over resampled training rows; attention at
    T in ATTN_T for a batch of ENC_B with one fully and one half masked row;
    LN at LN_FWD_ROWS x LN_FWD_WIDTHS (timed at M = ENC_B x ENC_T, N = 384)
    and GELU at M = ENC_B x ENC_T. → rows (name, err, ms, plain ms, shape)."""
    import numpy as np
    import torch

    from stract_tpu_torch.ops import encoder as E
    from stract_tpu_torch.ops import forest as FO

    out = []
    rng = np.random.default_rng(SEED + 4)
    deep = deep_forest(rows)
    for fo, depth in ((forest, forest.max_depth), (deep, 3)):
        leaf_sum = float(fo.leaf_value.abs().max(dim=1).values.sum())
        for k in FOREST_K:
            x = torch.from_numpy(rows[rng.integers(0, len(rows), size=k)]).to(DEVICE)
            run_k = lambda: FO.gbdt_forward(*fo._arrays(), x, depth)  # noqa: E731
            run_p = lambda: FO.gbdt_forward_plain(*fo._arrays(), x, depth)  # noqa: E731
            a, b = run_k(), run_p()
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6 * leaf_sum)
            want = tree_order_sum(walk_leaves(fo, x, depth)[0])
            if x.is_cuda and not torch.equal(a.view(torch.int32), want.view(torch.int32)):
                raise AssertionError(f"K4 at K = {k} differs from the tree-order f32 sum")
            if fo is forest:
                out.append(("forest", float((a - b).abs().max()), time_ms(run_k),
                            time_ms(run_p), k))
    log(f"[model kernels] K4 at K = {FOREST_K} on the trained forest and on "
        f"{FOREST_DEEP_TREES} trees of {FOREST_DEEP} levels walked to depth 3 with negative "
        f"feature indices: bit-equal to the tree-order f32 sum of the plain walk's leaves")

    g = torch.Generator().manual_seed(SEED)
    bf = lambda *shape: torch.randn(shape, generator=g).to(DEVICE, torch.bfloat16)  # noqa: E731
    for t in ATTN_T:
        q, k, v = bf(ENC_B, t, 12, 32), bf(ENC_B, t, 12, 32), bf(ENC_B, t, 12, 32)
        mask = torch.ones((ENC_B, t), dtype=torch.int32)
        mask[1, t // 2:] = 0
        mask[2] = 0  # fully masked: uniform weights, finite
        mask = mask.to(DEVICE)
        run_k = lambda: E.attention(q, k, v, mask)  # noqa: E731
        run_p = lambda: E.attention_plain(q, k, v, mask)  # noqa: E731
        a, b = run_k().float(), run_p().float()
        if not torch.isfinite(a).all():
            raise AssertionError("attention gave a non-finite value")
        torch.testing.assert_close(a, b, rtol=ENC_TOL[0], atol=2 * ENC_TOL[1])
        out.append(("attention", float((a - b).abs().max()), time_ms(run_k), time_ms(run_p), t))

    m = ENC_B * ENC_T
    err = 0.0
    for N in LN_FWD_WIDTHS:
        for M in LN_FWD_ROWS:
            x, r = bf(M, N), bf(M, N)
            w = (1 + 0.1 * torch.randn(N, generator=g)).to(DEVICE)
            bias = (0.1 * torch.randn(N, generator=g)).to(DEVICE)
            run_k = lambda: E.add_layernorm(x, r, w, bias, 1e-12)  # noqa: E731
            run_p = lambda: E.add_layernorm_plain(x, r, w, bias, 1e-12)  # noqa: E731
            got = run_k()
            err = max(err, bf16_step_close(got, run_p()))
            if not torch.equal(run_k(), got):
                raise AssertionError(f"two calls of the LayerNorm kernel differ at {M} x {N}")
            if (M, N) == (m, 384):
                ms, pms = time_ms(run_k), time_ms(run_p)
    out.append(("add_layernorm", err, ms, pms, m))

    y, yb = bf(m, 1536), (0.1 * torch.randn(1536, generator=g)).to(DEVICE, torch.bfloat16)
    run_k = lambda: E.bias_gelu(y, yb)  # noqa: E731
    run_p = lambda: E.bias_gelu_plain(y, yb)  # noqa: E731
    a, b = run_k().float(), run_p().float()
    torch.testing.assert_close(a, b, rtol=ENC_TOL[0], atol=ENC_TOL[1])
    out.append(("bias_gelu", float((a - b).abs().max()), time_ms(run_k), time_ms(run_p), m))
    return out


def deep_forest(rows):
    """A forest walked past what max_depth 3 lets it reach: FOREST_DEEP_TREES
    trees of FOREST_DEEP levels trained on the forest's rows (a seeded
    target), feature indices -3 (wraps into range) and -100 (wraps below 0,
    clamped) at two roots."""
    import numpy as np

    from stract_tpu_torch.ranking.models.lambdamart import LambdaMART

    x = np.asarray(rows[:2000], dtype=np.float32)
    y = x[:, 1] - 3 * x[:, 2] + np.sin(x[:, 9])
    fo = LambdaMART.train(x, y, num_trees=FOREST_DEEP_TREES, max_depth=FOREST_DEEP,
                          device="cpu")
    feature = fo.feature.clone()
    feature[0, 0], feature[1, 0] = -3, -100
    return LambdaMART(feature, *(t.numpy() for t in fo._arrays()[1:]), FOREST_DEEP,
                      device=DEVICE)


def tree_order_sum(vals):
    """Leaf values f32[T, K] (walk_leaves) summed in f32 in tree order t = 0
    .. T - 1, the reference's order."""
    import torch

    acc = torch.zeros(vals.shape[1], dtype=torch.float32, device=vals.device)
    for t in range(vals.shape[0]):
        acc = acc + vals[t]
    return acc


def walk_leaves(forest, x, depth: int) -> tuple:
    """The plain walk of every (tree, row) pair as the reference takes it,
    without the sum → (leaf values f32[T, K], the node visits it made: the
    steps taken before each walk reached its leaf or max_depth)."""
    import torch

    feature, threshold, left, right, leaf_value = forest._arrays()
    T, N = feature.shape
    K, F = x.shape
    cur = torch.zeros((T, K), dtype=torch.int32, device=x.device)
    rows = torch.arange(K, device=x.device)[None, :].expand(T, K)
    steps = 0
    for _ in range(depth):
        live = cur >= 0
        steps += int(live.sum())
        node = cur.clamp(0, N - 1).long()
        f = torch.gather(feature, 1, node).long()
        f = torch.where(f < 0, f + F, f).clamp(0, F - 1)
        nxt = torch.where(x[rows, f] <= torch.gather(threshold, 1, node),
                          torch.gather(left, 1, node), torch.gather(right, 1, node))
        cur = torch.where(live, nxt, cur)
    leaf = (-cur - 1).clamp(0, leaf_value.shape[1] - 1).long()
    return torch.gather(leaf_value, 1, leaf), steps


def lgbm_forest_phase(data_dir: str) -> dict:
    """K4 on LightGBM dumps at production sizes (LGBM_FORESTS), each written
    as LightGBM text from a seed (synthetic_lightgbm) and read back by
    LambdaMART.load, as `main.py serve --lambdamart FILE` reads it; both are
    past one block's shared memory, so K4 walks them in chunks of trees (the
    plan is checked to say so). At LGBM_K seeded normal rows each is held
    bit-equal to the tree-order f32 sum of the plain walk's leaves and
    within the forest tolerance of the plain version, and timed; its bound
    counts the node visits this run's rows make. → {"paths", "rows" (name,
    err, ms, plain ms, shape, bytes, ops, peak)}."""
    import numpy as np
    import torch

    from stract_tpu_torch.ops import forest as FO
    from stract_tpu_torch.ops import kernels
    from stract_tpu_torch.bench_corpus import synthetic_lightgbm
    from stract_tpu_torch.ranking.models.lambdamart import LambdaMART

    os.makedirs(data_dir, exist_ok=True)
    rng = np.random.default_rng(SEED + 14)
    x = torch.from_numpy(rng.normal(size=(LGBM_K, LGBM_F)).astype(np.float32)).to(DEVICE)
    paths, rows = [], []
    for trees, leaves in LGBM_FORESTS:
        path = os.path.join(data_dir, f"lightgbm_{trees}x{leaves}.txt")
        with open(path, "w") as fh:
            fh.write(synthetic_lightgbm(trees, leaves, LGBM_F, SEED + trees))
        fo = LambdaMART.load(path, device=DEVICE)
        T, N = fo.feature.shape
        L = fo.leaf_value.shape[1]
        plan = kernels.forest_plan(T, N, L, LGBM_F, LGBM_K)
        if (T, L) != (trees, leaves) or plan.trees >= T:
            raise AssertionError(f"the LightGBM forest read back as {T} x {L}, plan {plan}")
        depth = fo.max_depth
        run_k = lambda: FO.gbdt_forward(*fo._arrays(), x, depth)  # noqa: E731
        run_p = lambda: FO.gbdt_forward_plain(*fo._arrays(), x, depth)  # noqa: E731
        a, b = run_k(), run_p()
        leaf_sum = float(fo.leaf_value.abs().max(dim=1).values.sum())
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6 * leaf_sum)
        vals, steps = walk_leaves(fo, x, depth)
        if x.is_cuda and not torch.equal(a.view(torch.int32),
                                         tree_order_sum(vals).view(torch.int32)):
            raise AssertionError(f"K4 on {trees} x {leaves} leaves differs from the tree-order "
                                 "f32 sum")
        ms, pms = time_ms(run_k), time_ms(run_p)
        rows.append(("forest", float((a - b).abs().max()), ms, pms, (LGBM_K, f"{trees}x{leaves}"),
                     4 * LGBM_K * (LGBM_F + 1) + 16 * T * N + 4 * T * L, 2 * steps, PEAK_F32))
        log(f"[lightgbm] K4 on {trees} trees x {leaves} leaves (depth {depth}) at K = {LGBM_K}: "
            f"plan {tuple(plan)}, bit-equal to the tree-order f32 sum, kernel {ms:.4f} ms plain "
            f"{pms:.4f} ms, {steps} node visits")
        paths.append(path)
        del vals, fo
    return {"paths": paths, "rows": rows}


def lgbm_serve_phase(index_dir: str, models: dict, path: str) -> dict:
    """One pipeline-on HTTP round of the request mix with the LightGBM text at
    `path` as the forest, loaded as `main.py serve --lambdamart FILE` loads it
    (build_searcher's lambdamart, entrypoint/api.py build_pipeline), the
    trained encoders beside it: every request answered and every serving
    kernel, K4 on the chunked forest among them, launched. → serve_phase's
    record."""
    import torch

    from stract_tpu_torch.main import build_searcher

    on = build_searcher(index_dir, DEVICE, dual_encoder=models["dual"],
                        cross_encoder=models["cross"], lambdamart=path)
    forest = on.pipeline.recall.lambdamart
    if forest.num_trees != LGBM_FORESTS[0][0]:
        raise AssertionError(f"--lambdamart loaded {forest.num_trees} trees")
    served = serve_phase(on, SERVING, rounds=1)
    del on, forest
    torch.cuda.empty_cache()
    return served


def long_encoder_phase(index_dir: str, out_dir: str, tok) -> dict:
    """K5a, K14a and K5d past 512 tokens: K5a and K14a within one bf16 step
    of their plain versions' largest magnitude at LONG_ATTN (row 1 half, row
    2 fully, row 3 tail masked where B > 1; else the row's last fifth), each
    timed beside
    scaled_dot_product_attention with the additive mask and its backward; K5d
    forward + backward at LONG_POOL x 384 (random lengths, the last row fully
    masked), normalised, two calls bit-equal, timed; then
    train_dual_encoder(max_len=LONG_TRAIN_T) on MiniLM-L6 at full width (the
    30,522-piece vocab), batch LONG_TRAIN_B, LONG_TRAIN_STEPS steps, launch
    counts reset just before and read just after: K5a, K14a and K5d launched,
    the losses finite. → {"rows" (name, err, ms, plain ms, shape, bytes, ops,
    peak), "record"}."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from stract_tpu_torch.entrypoint.train_encoders import train_dual_encoder
    from stract_tpu_torch.models.bert import BertConfig
    from stract_tpu_torch.ops import encoder as E
    from stract_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    out = []
    g = torch.Generator().manual_seed(SEED + 15)
    bf = lambda *shape: torch.randn(shape, generator=g).to(DEVICE, torch.bfloat16)  # noqa: E731
    for Bl, Tl, Hl, d in LONG_ATTN:
        q, k, v, dout = bf(Bl, Tl, Hl, d), bf(Bl, Tl, Hl, d), bf(Bl, Tl, Hl, d), bf(Bl, Tl, Hl * d)
        mask = torch.ones((Bl, Tl), dtype=torch.int32)
        if Bl > 1:
            mask[1, Tl // 2:] = 0
            mask[2] = 0
            mask[3, Tl - Tl // 5:] = 0
        else:
            mask[0, Tl - Tl // 5:] = 0
        mask = mask.to(DEVICE)
        add = torch.zeros((Bl, 1, 1, Tl), dtype=torch.bfloat16, device=DEVICE)
        add.masked_fill_(mask[:, None, None, :] == 0, torch.finfo(torch.bfloat16).min)
        a, b = E.attention_forward(q, k, v, mask).float(), E.attention_plain(q, k, v, mask).float()
        if not torch.isfinite(a).all():
            raise AssertionError(f"attention gave a non-finite value at T = {Tl}")
        fwd_err = _step_close(a, b)
        del a, b
        got = E.attention_backward(q, k, v, mask, dout)
        bwd_err = max(_step_close(x, y) for x, y in
                      zip(got, E.attention_backward_plain(q, k, v, mask, dout)))
        if not all(torch.equal(x, y) for x, y in zip(E.attention_backward(q, k, v, mask, dout),
                                                     got)):
            raise AssertionError(f"two calls of the attention backward differ at T = {Tl}")
        del got
        leaves = [x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v)]
        o = F.scaled_dot_product_attention(*leaves, add)
        do = dout.view(Bl, Tl, Hl, d).transpose(1, 2)
        times = (time_ms(lambda: E.attention_forward(q, k, v, mask)),
                 time_ms(lambda: E.attention_plain(q, k, v, mask), 3),
                 time_ms(lambda: F.scaled_dot_product_attention(*(x.detach() for x in leaves),
                                                                add)),
                 time_ms(lambda: E.attention_backward(q, k, v, mask, dout)),
                 time_ms(lambda: E.attention_backward_plain(q, k, v, mask, dout), 3),
                 time_ms(lambda: torch.autograd.grad(o, leaves, do, retain_graph=True)))
        del o, leaves
        elems = Bl * Tl * Hl * d
        shape = (Bl, Tl, Hl, d)
        out.append(("attention", fwd_err, times[0], times[1], shape, 4 * elems * 2 + 4 * Bl * Tl,
                    4 * Bl * Hl * Tl * Tl * d, PEAK_BF16))
        out.append(("attention_backward", bwd_err, times[3], times[4], shape,
                    7 * elems * 2 + 4 * Bl * Tl, 10 * Bl * Hl * Tl * Tl * d, PEAK_BF16))
        log(f"[long] K5a/K14a B={Bl} T={Tl} heads={Hl} d={d}: forward kernel {times[0]:.4f} ms "
            f"plain {times[1]:.4f} sdpa {times[2]:.4f} max_abs_err {fwd_err:.3g}; backward kernel "
            f"{times[3]:.4f} ms plain {times[4]:.4f} sdpa {times[5]:.4f} max_abs_err {bwd_err:.3g}")
        torch.cuda.empty_cache()

    for Bp, Tp in LONG_POOL:
        lens = torch.randint(1, Tp + 1, (Bp, 1), generator=g)
        lens[0], lens[-1] = Tp, 0
        mp = (torch.arange(Tp) < lens).to(torch.int32).to(DEVICE)
        h, cot = bf(Bp, Tp, 384), torch.randn((Bp, 384), generator=g).to(DEVICE)

        def pool(fwd, bwd):
            pooled, raw = fwd(h, mp, True)
            return pooled, raw, bwd(mp, raw, cot, True, torch.bfloat16)
        run_k = lambda: pool(E.mean_pool_forward, E.mean_pool_backward)  # noqa: E731
        run_p = lambda: pool(E.mean_pool_plain, E.mean_pool_backward_plain)  # noqa: E731
        got = run_k()
        err = max(_step_close(a, b) for a, b in zip(got, run_p()))
        if not all(torch.equal(a, b) for a, b in zip(run_k(), got)):
            raise AssertionError(f"two calls of the pool kernels differ at {Bp} x {Tp}")
        kept = int(mp.sum())
        ms, pms = time_ms(run_k), time_ms(run_p)
        out.append(("mean_pool", err, ms, pms, (Bp, Tp, 384),
                    (kept + Bp * Tp) * 384 * 2 + 8 * Bp * Tp + 4 * Bp * 384 * 4,
                    4 * Bp * Tp * 384, PEAK_F32))
        log(f"[long] K5d forward + backward at {Bp} x {Tp} x 384: kernel {ms:.4f} ms plain "
            f"{pms:.4f} ms max_abs_err {err:.3g}, two calls bit-equal")

    torch.cuda.synchronize()
    kernels.reset_launches()
    timing = {}
    losses = train_dual_encoder(index_dir, out_dir, steps=LONG_TRAIN_STEPS, batch=LONG_TRAIN_B,
                                max_len=LONG_TRAIN_T, cfg=BertConfig.mini_lm(vocab_size=VOCAB),
                                tokenizer=tok, log=lambda m: None, device=DEVICE, timing=timing)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    if len(losses) != LONG_TRAIN_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"training at {LONG_TRAIN_T} tokens gave the losses {losses}")
    if not all(launches[k] for k in ("attention", "attention_backward", "mean_pool")):
        raise AssertionError(f"training at {LONG_TRAIN_T} tokens missed a kernel: {launches}")
    torch.cuda.empty_cache()
    return {"rows": out, "record": {
        "train_tokens": LONG_TRAIN_T, "train_batch": LONG_TRAIN_B, "steps": LONG_TRAIN_STEPS,
        "losses": [float(x) for x in losses], "s_per_step": timing["seconds"] / timing["steps"],
        "launches": {k: v for k, v in launches.items() if v},
        "seconds": time.perf_counter() - t0}}


def bf16_step_close(a, b) -> float:
    """Raise unless bf16 tensors a and b are equal or neighbouring bf16
    values wherever they differ by more than f32 rounding of b's largest
    magnitude (2^-16 max |b|: a value that cancels to near 0 is only as exact
    as its terms); → max |a - b|."""
    import torch

    if not torch.isfinite(a.float()).all():
        raise AssertionError("a kernel gave a non-finite value")
    if not a.numel():
        return 0.0

    def ordinal(t):
        bits = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    diff = (a.float() - b.float()).abs()
    far = diff > 2 ** -16 * float(b.float().abs().max())
    steps = int(((ordinal(a) - ordinal(b)).abs() * far).max())
    if steps > 1:
        raise AssertionError(f"{steps} bf16 steps from the plain version")
    return float(diff.max())


def _step_close(a, b) -> float:
    """Raise unless a is within one bf16 step of b's largest magnitude; →
    max |a - b|."""
    import torch

    a, b = a.float(), b.float()
    if not torch.isfinite(a).all():
        raise AssertionError("a kernel gave a non-finite value")
    torch.testing.assert_close(a, b, rtol=STEP, atol=STEP * float(b.abs().max()))
    return float((a - b).abs().max())


def layernorm_library(x, r, w, b):
    """K5b's library call on its inputs: F.layer_norm of the bf16 sum
    widened to f32, with the f32 weight and bias, cast to bf16 (the
    reference's function; PyTorch's CUDA layer_norm takes no bf16 input with
    an f32 weight). → the function to time."""
    import torch
    import torch.nn.functional as F

    N = x.shape[-1]
    return lambda: F.layer_norm((x + r).float(), (N,), w, b, 1e-12).to(torch.bfloat16)


def layernorm_backward_library(x, r, w, dy):
    """K14b's library call on its inputs: the backward of F.layer_norm over
    the f32 widened sum through autograd (native_layer_norm_backward),
    graph retained (it rounds differently from the reference: a timing
    only). → the function to time."""
    import torch
    import torch.nn.functional as F

    N = x.shape[-1]
    s = (x + r).float().requires_grad_(True)
    wl, bl = w.clone().requires_grad_(True), torch.zeros_like(w).requires_grad_(True)
    y = F.layer_norm(s, (N,), wl, bl, 1e-12)
    g = dy.float()
    return lambda: torch.autograd.grad(y, (s, wl, bl), g, retain_graph=True)


def bias_gelu_backward_library(y, b, gout):
    """K14c's library call on its inputs: aten.gelu_backward (tanh) at y + b,
    the bias add inside it, and the f32 column sum of the result cast to
    bf16 (it rounds once, not at each step of the chain as the reference:
    a timing only). → the function to time."""
    import torch

    def run():
        dy = torch.ops.aten.gelu_backward(gout, y + b, approximate="tanh")
        return dy, dy.float().sum(dim=0).to(torch.bfloat16)
    return run


def training_kernel_phase(dual_dir: str) -> list:
    """K14a-d and K5d against their plain versions at the training shapes:
    attention backward at B=TRAIN_B, T=TRAIN_T with one fully and one half
    masked row; LN backward at TRAIN_B*TRAIN_T x 384; GELU backward at
    TRAIN_B*TRAIN_T x 1536; K5d forward + backward at TRAIN_B x TRAIN_T x 384;
    AdamW over the trained dual encoder's 22.7M parameters for 3 steps from
    the same state. → rows (name, err, ms, plain ms, shape)."""
    import torch

    from stract_tpu_torch import optim
    from stract_tpu_torch.models.store import load_encoder
    from stract_tpu_torch.ops import encoder as E

    out = []
    g = torch.Generator().manual_seed(SEED + 5)
    bf = lambda *shape: torch.randn(shape, generator=g).to(DEVICE, torch.bfloat16)  # noqa: E731
    B, T = TRAIN_B, TRAIN_T
    q, k, v, dout = bf(B, T, 12, 32), bf(B, T, 12, 32), bf(B, T, 12, 32), bf(B, T, 384)
    mask = torch.ones((B, T), dtype=torch.int32)
    mask[1, T // 2:] = 0
    mask[2] = 0
    mask = mask.to(DEVICE)
    run_k = lambda: E.attention_backward(q, k, v, mask, dout)  # noqa: E731
    run_p = lambda: E.attention_backward_plain(q, k, v, mask, dout)  # noqa: E731
    err = max(_step_close(a, b) for a, b in zip(run_k(), run_p()))
    out.append(("attention_backward", err, time_ms(run_k), time_ms(run_p), T))

    m = B * T
    for N in LN_WIDTHS:  # MiniLM's first (the main row), then BertConfig.tiny's and BERT-base's
        x, r, dy = bf(m, N), bf(m, N), bf(m, N)
        w = (1 + 0.1 * torch.randn(N, generator=g)).to(DEVICE)
        run_k = lambda: E.add_layernorm_backward(x, r, w, 1e-12, dy)  # noqa: E731
        run_p = lambda: E.add_layernorm_backward_plain(x, r, w, 1e-12, dy)  # noqa: E731
        (ds, dw, db), (ps, pw, pb) = run_k(), run_p()
        err = _step_close(ds, ps)
        for a, b in ((dw, pw), (db, pb)):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4 * float(b.abs().max()))
            err = max(err, float((a - b).abs().max()))
        if not all(torch.equal(a, b) for a, b in zip(run_k(), (ds, dw, db))):
            raise AssertionError(f"two calls of the LayerNorm backward kernel differ at N={N}")
        lib = time_ms(layernorm_backward_library(x, r, w, dy))
        log(f"[train] K14b at {m} x {N}: native_layer_norm_backward through autograd "
            f"{lib:.4f} ms")
        out.append(("add_layernorm_backward", err, time_ms(run_k), time_ms(run_p),
                    m if N == 384 else (m, N)))

    # K14c: MiniLM's FFN at the dual step's rows (the main row), BERT-base's at
    # 4 x 512 tokens (timed); a width off the 16-byte path and a misaligned
    # view (checked); each call's second run bit-equal
    k14c, checked = [], 0.0
    for M, N, timed in ((m, 1536, True), (4 * 512, 3072, True), (33, 1000, False),
                        (300, 1536, False)):
        if timed or N != 1536:
            y, gout = bf(M, N), bf(M, N)
            yb = (0.5 * torch.randn(N, generator=g)).to(DEVICE, torch.bfloat16)
        else:  # contiguous views 2 bytes past a 16-byte boundary: single elements
            y, gout, yb = (bf(n + 1)[1:] for n in (M * N, M * N, N))
            y, gout = y.view(M, N), gout.view(M, N)
        run_k = lambda: E.bias_gelu_backward(y, yb, gout)  # noqa: E731
        run_p = lambda: E.bias_gelu_backward_plain(y, yb, gout)  # noqa: E731
        got = run_k()
        err = max(_step_close(a, b) for a, b in zip(got, run_p()))
        if not all(torch.equal(a, b) for a, b in zip(run_k(), got)):
            raise AssertionError(f"two calls of the GELU backward kernel differ at {M} x {N}")
        if timed:
            lib = time_ms(bias_gelu_backward_library(y, yb, gout))
            log(f"[train] K14c at {M} x {N}: aten.gelu_backward (tanh) of y + b and the "
                f"column sum {lib:.4f} ms")
            k14c.append((err, time_ms(run_k), time_ms(run_p),
                         m if (M, N) == (m, 1536) else (M, N)))
        else:
            checked = max(checked, err)
            log(f"[train] K14c at {M} x {N} ({'misaligned view' if N == 1536 else 'odd width'}): "
                f"max abs err {err:.3g}, two calls bit-equal")
    out += [("bias_gelu_backward", max(err, checked), ms, pms, shape)
            for err, ms, pms, shape in k14c]

    # K5d: the main row at the dual step's shape (the attention's mask above,
    # normalised), then POOL_B x POOL_T with random lengths, the last row fully
    # masked past one row; normalised and not, second calls bit-equal
    err = 0.0
    for Bp in POOL_B:
        for Tp in POOL_T:
            if (Bp, Tp) == (B, T):
                mp = mask
            else:
                lens = torch.randint(1, Tp + 1, (Bp, 1), generator=g)
                lens[0] = Tp
                if Bp > 1:
                    lens[-1] = 0
                mp = (torch.arange(Tp) < lens).to(torch.int32).to(DEVICE)
            for normalize in (True, False):
                h, cot = bf(Bp, Tp, 384), torch.randn((Bp, 384), generator=g).to(DEVICE)

                def pool(fwd, bwd):
                    pooled, raw = fwd(h, mp, normalize)
                    return pooled, raw, bwd(mp, raw, cot, normalize, torch.bfloat16)
                run_k = lambda: pool(E.mean_pool_forward, E.mean_pool_backward)  # noqa: E731
                run_p = lambda: pool(E.mean_pool_plain,  # noqa: E731
                                     E.mean_pool_backward_plain)
                got = run_k()
                err = max(err, *(_step_close(a, b) for a, b in zip(got, run_p())))
                if not all(torch.equal(a, b) for a, b in zip(run_k(), got)):
                    raise AssertionError(f"two calls of the pool kernels differ at {Bp} x {Tp}")
                if (Bp, Tp, normalize) == (B, T, True):
                    ms, pms = time_ms(run_k), time_ms(run_p)
    out.append(("mean_pool", err, ms, pms, B * T))

    _, masters, _, _ = load_encoder(dual_dir, "dual")
    p0 = torch.cat([t.reshape(-1) for t in masters.values()]).to(DEVICE)
    n = p0.numel()
    grads = [torch.randn(n, generator=g).to(DEVICE) for _ in range(3)]

    def adamw(update, state):
        p, mo, ve = state
        for i, gr in enumerate(grads, 1):
            update(p, gr, mo, ve, 3e-4, 0.9, 0.999, 1e-8, 1e-4, 1 - 0.9 ** i, 1 - 0.999 ** i)
        return p, mo, ve
    fresh = lambda: (p0.clone(), torch.zeros_like(p0), torch.zeros_like(p0))  # noqa: E731
    got, ref = adamw(optim.adamw_update, fresh()), adamw(optim.adamw_update_plain, fresh())
    err = 0.0
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6 * float(b.abs().max()))
        err = max(err, float((a - b).abs().max()))
    state = fresh()
    run_k = lambda: optim.adamw_update(state[0], grads[0], state[1], state[2], 3e-4, 0.9,  # noqa
                                       0.999, 1e-8, 1e-4, 0.1, 0.001)
    run_p = lambda: optim.adamw_update_plain(state[0], grads[0], state[1], state[2], 3e-4,  # noqa
                                             0.9, 0.999, 1e-8, 1e-4, 0.1, 0.001)
    out.append(("adamw", err, time_ms(run_k), time_ms(run_p), n))
    return out


def attention_grid_phase() -> list:
    """K5a and K14a against their plain versions at every head dim d in
    GRID_D and T in GRID_T (B = GRID_B, 12 heads; row 1 half, row 2 fully,
    row 3 tail masked), each timed beside scaled_dot_product_attention with
    the additive mask (forward) and its backward through autograd; each
    row logged. → rows (name, err, ms, plain ms, shape, bytes, ops, peak)."""
    import torch
    import torch.nn.functional as F

    from stract_tpu_torch.ops import encoder as E

    out = []
    g = torch.Generator().manual_seed(SEED + 12)
    bf = lambda *shape: torch.randn(shape, generator=g).to(DEVICE, torch.bfloat16)  # noqa: E731
    Bg, Hg = GRID_B, 12
    for d in GRID_D:
        for t in GRID_T:
            q, k, v, dout = bf(Bg, t, Hg, d), bf(Bg, t, Hg, d), bf(Bg, t, Hg, d), bf(Bg, t, Hg * d)
            mask = torch.ones((Bg, t), dtype=torch.int32)
            mask[1, t // 2:] = 0
            mask[2] = 0
            mask[3, t - max(1, t // 5):] = 0
            mask = mask.to(DEVICE)
            add = torch.zeros((Bg, 1, 1, t), dtype=torch.bfloat16, device=DEVICE)
            add.masked_fill_(mask[:, None, None, :] == 0, torch.finfo(torch.bfloat16).min)
            a = E.attention_forward(q, k, v, mask).float()
            b = E.attention_plain(q, k, v, mask).float()
            if not torch.isfinite(a).all():
                raise AssertionError(f"attention gave a non-finite value at d={d}, T={t}")
            torch.testing.assert_close(a, b, rtol=ENC_TOL[0], atol=2 * ENC_TOL[1])
            fwd_err = float((a - b).abs().max())
            bwd_err = max(_step_close(x, y) for x, y in zip(
                E.attention_backward(q, k, v, mask, dout),
                E.attention_backward_plain(q, k, v, mask, dout)))
            leaves = [x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v)]
            o = F.scaled_dot_product_attention(*leaves, add)
            do = dout.view(Bg, t, Hg, d).transpose(1, 2)
            times = (time_ms(lambda: E.attention_forward(q, k, v, mask)),
                     time_ms(lambda: E.attention_plain(q, k, v, mask)),
                     time_ms(lambda: F.scaled_dot_product_attention(*(x.detach() for x in leaves),
                                                                    add)),
                     time_ms(lambda: E.attention_backward(q, k, v, mask, dout)),
                     time_ms(lambda: E.attention_backward_plain(q, k, v, mask, dout)),
                     time_ms(lambda: torch.autograd.grad(o, leaves, do, retain_graph=True)))
            del o, leaves
            shape = (Bg, t, Hg, d)
            elems = Bg * t * Hg * d
            out.append(("attention", fwd_err, times[0], times[1], shape, 4 * elems * 2 + 4 * Bg * t,
                        4 * Bg * Hg * t * t * d, PEAK_BF16))
            out.append(("attention_backward", bwd_err, times[3], times[4], shape,
                        7 * elems * 2 + 4 * Bg * t, 10 * Bg * Hg * t * t * d, PEAK_BF16))
            log(f"[attention grid] d={d} T={t} B={Bg} heads={Hg}: forward kernel "
                f"{times[0]:.4f} ms plain {times[1]:.4f} sdpa {times[2]:.4f} max_abs_err "
                f"{fwd_err:.3g}; backward kernel {times[3]:.4f} ms plain {times[4]:.4f} sdpa "
                f"{times[5]:.4f} max_abs_err {bwd_err:.3g}")
    return out


def train_encoders_phase(index_dir: str, out_dir: str) -> dict:
    """`python -m stract_tpu_torch.main train-encoders both INDEX OUT --steps
    2` at its other defaults (--device cuda, BertConfig.tiny: head dim 16,
    the dual's 48 tokens and the cross's 64) through the entry point's main,
    its output captured; launch counts reset just before and read just
    after: K5a and K14a launched, every printed loss finite, both encoders
    saved. → {"losses", "launches", "seconds"}."""
    import io
    import re

    import numpy as np

    from stract_tpu_torch.main import main as port_main
    from stract_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    kernels.reset_launches()
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        port_main(["train-encoders", "both", index_dir, out_dir, "--steps", "2"])
    launches = dict(kernels.LAUNCHES)
    losses = [float(x) for pair in re.findall(r"\(loss (\S+) → (\S+)\)", printed.getvalue())
              for x in pair]
    if len(losses) != 4 or not np.isfinite(losses).all():
        raise AssertionError(f"train-encoders printed the losses {losses}:\n{printed.getvalue()}")
    if not (launches["attention"] and launches["attention_backward"]):
        raise AssertionError(f"train-encoders launched no attention kernel: {launches}")
    for kind in ("dual", "cross"):
        if not os.path.exists(os.path.join(out_dir, f"{kind}_encoder", "config.json")):
            raise AssertionError(f"train-encoders saved no {kind} encoder")
    return {"losses": losses, "launches": {k: v for k, v in launches.items() if v},
            "seconds": time.perf_counter() - t0}


def bert_base_phase(index_dir: str, out_dir: str, tok) -> dict:
    """BERT-base width (BertConfig(): 12 layers, 768 wide, 12 heads of 64)
    on the card: DualEncoder.random_init embeds one batch of BASE_EMBED_B long
    texts at 256 tokens, held to the same encoder through the plain versions
    (cosine >= 0.999 a row); then train_dual_encoder(cfg=BertConfig(),
    max_len=512) takes BASE_STEPS steps at batch BASE_TRAIN_B, losses finite.
    Launch counts reset just before each and read just after: K5a (and in
    training K14a) launched. → the record."""
    import numpy as np
    import torch

    from stract_tpu_torch import bench_corpus as bc
    from stract_tpu_torch.entrypoint.train_encoders import train_dual_encoder
    from stract_tpu_torch.models.bert import BertConfig
    from stract_tpu_torch.models.dual_encoder import DualEncoder
    from stract_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    cfg = BertConfig()
    rng = np.random.default_rng(SEED + 13)
    texts = [" ".join(bc.sample_queries(rng, 150)) for _ in range(BASE_EMBED_B)]
    enc = DualEncoder.random_init(cfg, tok, seed=SEED, device=DEVICE)
    filled = tok.encode_batch(texts, enc.max_len)[1].sum(axis=1)
    if enc.max_len != 256 or int(filled.max()) != 256:
        raise AssertionError("the BERT-base batch does not fill 256 tokens")
    torch.cuda.synchronize()
    kernels.reset_launches()
    emb = enc.embed(texts)
    torch.cuda.synchronize()
    embed_launches = dict(kernels.LAUNCHES)
    with plain_versions():
        ref = enc.embed(texts)
    cos = float((emb * ref).sum(axis=1).min())
    if emb.shape != (BASE_EMBED_B, 768) or not np.isfinite(emb).all() or cos < 0.999:
        raise AssertionError(f"BERT-base embeddings {emb.shape}, finite={np.isfinite(emb).all()},"
                             f" cosine to the plain versions {cos}")
    if not embed_launches["attention"]:
        raise AssertionError(f"the BERT-base embedding launched no attention: {embed_launches}")
    del enc
    torch.cuda.empty_cache()
    kernels.reset_launches()
    timing = {}
    losses = train_dual_encoder(index_dir, out_dir, steps=BASE_STEPS, batch=BASE_TRAIN_B,
                                max_len=BASE_TRAIN_T, cfg=cfg, tokenizer=tok, log=lambda m: None,
                                device=DEVICE, timing=timing)
    train_launches = dict(kernels.LAUNCHES)
    if not np.isfinite(losses).all():
        raise AssertionError(f"BERT-base training gave the losses {losses}")
    if not (train_launches["attention"] and train_launches["attention_backward"]):
        raise AssertionError(f"BERT-base training launched no attention: {train_launches}")
    torch.cuda.empty_cache()
    return {"layers": cfg.num_layers, "hidden": cfg.hidden_size, "heads": cfg.num_heads,
            "head_dim": cfg.hidden_size // cfg.num_heads, "embed_tokens": 256,
            "embed_min_cosine_vs_plain": cos, "train_tokens": BASE_TRAIN_T,
            "train_batch": BASE_TRAIN_B, "losses": [float(x) for x in losses],
            "s_per_step": timing["seconds"] / timing["steps"],
            "embed_launches": {k: v for k, v in embed_launches.items() if v},
            "train_launches": {k: v for k, v in train_launches.items() if v},
            "seconds": time.perf_counter() - t0}


def train_step_timing(tok, steps: int = 5) -> dict:
    """One whole dual-encoder train step (InfoNCE, B=TRAIN_B, T=TRAIN_T,
    MiniLM-L6 with the full vocab) with kernels and with plain versions, in
    turns (plain, kernels, kernels, plain) → ms per step of each."""
    import numpy as np
    import torch

    from stract_tpu_torch import bench_corpus as bc
    from stract_tpu_torch.models.bert import BertConfig, BertForEmbedding, random_init
    from stract_tpu_torch.optim import AdamW
    from stract_tpu_torch.parallel.train import info_nce_loss, train_step

    rng = np.random.default_rng(SEED + 6)
    queries = bc.sample_queries(rng, TRAIN_B)
    q_ids, q_mask, _ = tok.encode_batch(queries, TRAIN_T)
    d_ids, d_mask, _ = tok.encode_batch([" ".join(bc.sample_queries(rng, 20)) for _ in queries],
                                        TRAIN_T)
    batch = {k: torch.from_numpy(a).to(DEVICE) for k, a in
             (("q_ids", q_ids), ("q_mask", q_mask), ("d_ids", d_ids), ("d_mask", d_mask))}
    model = random_init(BertForEmbedding(BertConfig.mini_lm(vocab_size=VOCAB),
                                         param_dtype=torch.float32), SEED).to(DEVICE)
    opt = AdamW(model.parameters(), 3e-4)

    def timed():
        train_step(model, opt, batch, info_nce_loss)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            train_step(model, opt, batch, info_nce_loss)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / steps

    res = {"kernels": [], "plain": []}
    for kind in ("plain", "kernels", "kernels", "plain"):
        if kind == "plain":
            with plain_versions():
                res[kind].append(timed())
        else:
            res[kind].append(timed())
    return {k: min(v) for k, v in res.items()}


def cross_entropy_library(logits, labels):
    """K15c's library call on its inputs: F.cross_entropy's value and its
    gradient with respect to the logits (torch.autograd.grad), as the kernel
    returns both. → the function to time."""
    import torch
    import torch.nn.functional as F

    leaf = logits.detach().requires_grad_(True)

    def run():
        loss = F.cross_entropy(leaf, labels)
        return loss, torch.autograd.grad(loss, leaf)
    return run


def soft_margin_library(s_pos, s_neg):
    """K15c's pair head's library call on its inputs: F.soft_margin_loss of
    s_pos - s_neg against ones (mean softplus(-x), the undistilled head) and
    its gradients in both scores through autograd. → the function to time."""
    import torch
    import torch.nn.functional as F

    a, b = (t.detach().requires_grad_(True) for t in (s_pos, s_neg))
    ones = torch.ones_like(a)

    def run():
        loss = F.soft_margin_loss(a - b, ones)
        return loss, torch.autograd.grad(loss, (a, b))
    return run


def loss_head_rows(g, library: dict) -> list:
    """K15c's two heads against their plain versions (rtol 1e-5, atol 1e-7)
    on the card, two calls of each bit-equal: the pair head at MOE_B pairs,
    plain and distilled (the cross encoder's and the MoE steps' shapes),
    beside F.soft_margin_loss and its gradient; the InfoNCE head at each
    INFO_NCE_B rows, beside F.cross_entropy and its gradient. Library times
    go into `library` under each head's main shape. → kernel_phase rows
    (name, default_static, err, ms, plain ms, shape, bytes, ops)."""
    import torch

    from stract_tpu_torch.ops import losses as LO

    def held(run_k, run_p, what) -> float:
        got, err = run_k(), 0.0
        for a, c in zip(got, run_p()):
            torch.testing.assert_close(a, c, rtol=1e-5, atol=1e-7)
            err = max(err, float((a - c).abs().max()))
        if not all(torch.equal(a, c) for a, c in zip(run_k(), got)):
            raise AssertionError(f"two calls of the {what} head differ")
        return err

    rows = []
    sp_, sn_, tp_, tn_ = (torch.randn(MOE_B, generator=g).to(DEVICE) for _ in range(4))
    for kind, args in (("pairwise", (sp_, sn_)), ("distilled", (sp_, sn_, tp_, tn_, MOE_ALPHA))):
        run_k = lambda: LO.pair_loss_forward(*args)  # noqa: E731
        run_p = lambda: LO.pair_loss_plain(*args)  # noqa: E731
        err = held(run_k, run_p, f"{kind} pair")
        n_in = 4 if kind == "distilled" else 2
        rows.append(("pair_loss", True, err, time_ms(run_k), time_ms(run_p), (MOE_B, kind),
                     4 * MOE_B * (n_in + 2) + 4, 20 * MOE_B))
    lib = time_ms(soft_margin_library(sp_, sn_))
    library["pair_loss"] = lib
    log(f"[moe] K15c pair head at {MOE_B} pairs: F.soft_margin_loss and its gradient {lib:.4f} ms")
    for B in INFO_NCE_B:
        logits = 20.0 * torch.randn((B, B), generator=g).to(DEVICE)
        run_k = lambda: LO.info_nce_forward(logits)  # noqa: E731
        run_p = lambda: LO.info_nce_plain(logits)  # noqa: E731
        err = held(run_k, run_p, "InfoNCE")
        rows.append(("info_nce", True, err, time_ms(run_k), time_ms(run_p), B,
                     4 * B * B * 2 + 4, 8 * B * B))
        lib = time_ms(cross_entropy_library(logits, torch.arange(B, device=DEVICE)))
        if B == TRAIN_B:
            library["info_nce"] = lib
        log(f"[moe] K15c InfoNCE head at B = {B}: F.cross_entropy and its gradient {lib:.4f} ms")
    return rows


def moe_phase(index_dir: str, dual_dir: str, card: str) -> dict:
    """The MoE training path on the card: a MiniLM-L6 cross encoder (full
    width, the 30,522-piece vocab, mean readout) from
    make_train_state(num_experts=MOE_E), its shared trunk (embeddings,
    attention, LayerNorms) warm-started from the trained dual encoder as the
    smoke's cross recipe does, trained MOE_STEPS distilled steps of MOE_B
    pairs x TRAIN_T tokens from the smoke's triples with the dual teacher's
    scaled cosines as targets; launch counts reset just before and read just
    after. The same steps through the plain versions from the same start;
    one step timed in turns; K15a-d held against their plain versions at the
    step's shapes. → {"record", "rows" (as kernel_phase's), "launches",
    "library"}."""
    import numpy as np
    import torch

    from stract_tpu_torch import optim
    from stract_tpu_torch.entrypoint.train_encoders import synthesize_triples
    from stract_tpu_torch.models.dual_encoder import DualEncoder
    from stract_tpu_torch.models.store import load_encoder
    from stract_tpu_torch.ops import kernels
    from stract_tpu_torch.ops import moe as MO
    from stract_tpu_torch.parallel.train import distill_loss, make_train_state, train_step

    t0 = time.perf_counter()
    triples = synthesize_triples(index_dir, 4096, seed=SEED)
    teacher = DualEncoder.load(dual_dir, device=DEVICE)
    tok = teacher.tokenizer
    rng = np.random.default_rng(SEED + 8)
    picks = [rng.integers(0, len(triples), MOE_B) for _ in range(MOE_STEPS)]
    used = sorted({int(j) for p in picks for j in p})
    qe, pe, ne = (np.asarray(teacher.embed([triples[j][i] for j in used])) for i in range(3))
    target = dict(zip(used, zip(TEACHER_SCALE * (qe * pe).sum(1), TEACHER_SCALE * (qe * ne).sum(1))))
    del teacher
    feeds = []
    for pick in picks:
        p = tok.encode_batch([(triples[j][0], triples[j][1]) for j in pick], TRAIN_T)
        n = tok.encode_batch([(triples[j][0], triples[j][2]) for j in pick], TRAIN_T)
        feed = {k: torch.from_numpy(np.ascontiguousarray(a)).to(DEVICE) for k, a in zip(
            ("pos_ids", "pos_mask", "pos_types", "neg_ids", "neg_mask", "neg_types"), (*p, *n))}
        for i, k in enumerate(("t_pos", "t_neg")):
            feed[k] = torch.tensor([target[int(j)][i] for j in pick], dtype=torch.float32,
                                   device=DEVICE)
        feeds.append(feed)
    d_cfg, masters, _, _ = load_encoder(dual_dir, "dual")
    cfg = dataclasses.replace(d_cfg, score_pool="mean")  # MiniLM-L6, the smoke's vocab
    trunk = {k: v for k, v in masters.items() if k.startswith("bert.")}

    def fresh():
        model, opt = make_train_state(cfg, MOE_LR, seed=SEED, num_experts=MOE_E, device=DEVICE)
        with torch.no_grad():  # into the optimizer's flat buffers, in place
            for name, prm in model.named_parameters():
                if name in trunk:
                    prm.copy_(trunk[name].to(prm.dtype))
        return model, opt

    def run():
        model, opt = fresh()
        torch.cuda.synchronize()
        kernels.reset_launches()
        losses = [float(train_step(model, opt, f, distill_loss, alpha=MOE_ALPHA)) for f in feeds]
        torch.cuda.synchronize()
        return losses, dict(kernels.LAUNCHES), model, opt

    losses_k, launches, model, opt = run()
    with plain_versions():
        losses_p, _, m_plain, _ = run()
    del m_plain
    if not np.isfinite(losses_k).all():
        raise AssertionError(f"the MoE steps gave a non-finite loss: {losses_k}")
    first, last = float(np.mean(losses_k[:5])), float(np.mean(losses_k[-5:]))
    if not last < first:
        raise AssertionError(f"the MoE loss did not fall: first 5 {first}, last 5 {last}")
    if any(launches[k] == 0 for k in MOE_KERNELS):
        raise AssertionError(f"a kernel was not launched by the MoE steps: {launches}")
    curve = max(abs(a - b) / abs(b) for a, b in zip(losses_k, losses_p))
    if curve > MOE_CURVE_RTOL:
        raise AssertionError(f"MoE loss curves differ by {curve:.3g} relative: {losses_k} vs "
                             f"{losses_p}")
    n_expert = sum(p.numel() for p in model.parameters() if p.dtype == torch.bfloat16)

    def timed():
        train_step(model, opt, feeds[0], distill_loss, alpha=MOE_ALPHA)  # warm-up
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for f in feeds[1:1 + MOE_TIMED]:
            train_step(model, opt, f, distill_loss, alpha=MOE_ALPHA)
        torch.cuda.synchronize()
        return (time.perf_counter() - t1) * 1e3 / MOE_TIMED
    step_ms = {"kernels": [], "plain": []}
    for kind in ("plain", "kernels", "kernels", "plain"):
        with plain_versions() if kind == "plain" else contextlib.nullcontext():
            step_ms[kind].append(timed())
    step_ms = {k: min(v) for k, v in step_ms.items()}

    # K15a-d against their plain versions at the step's shapes
    rows, library = [], {}
    g = torch.Generator().manual_seed(SEED + 9)
    N, H = MOE_B * TRAIN_T, cfg.hidden_size
    x = torch.randn((N, H), generator=g).to(DEVICE, torch.bfloat16)
    moe0 = model.bert.layer_0.moe
    w, b = moe0.router.weight.detach().contiguous(), moe0.router.bias.detach().contiguous()
    pk, tk, gk = MO.router_forward(x, w, b)
    pp, tp, gp = MO.router_plain(x, w, b)
    torch.testing.assert_close(pk, pp, rtol=1e-5, atol=1e-7)
    top2 = pp.topk(2, dim=1).values
    clear = (top2[:, 0] - top2[:, 1]) > 1e-5
    if not torch.equal(tk[clear], tp[clear]):
        raise AssertionError("the router kernel chose other experts")
    err = _step_close(gk, gp)
    # the router's whole VJP: dx, and the gradients of its weight and bias
    dgate = torch.randn(N, generator=g).to(DEVICE, torch.bfloat16)
    got = MO.router_backward(x, pp, tp, dgate, w)
    (dxk, dwk, dbk), (dxp, dwp, dbp) = got, MO.router_backward_plain(x, pp, tp, dgate, w)
    for a, c in ((dwk, dwp), (dbk, dbp)):
        torch.testing.assert_close(a, c, rtol=1e-5, atol=1e-6 * float(c.abs().max()))
    if not all(torch.equal(a, c) for a, c in zip(MO.router_backward(x, pp, tp, dgate, w), got)):
        raise AssertionError("two calls of the router's backward differ")
    err = max(err, float((pk - pp).abs().max()), _step_close(dxk, dxp),
              float((dwk - dwp).abs().max()), float((dbk - dbp).abs().max()))
    Ex = MOE_E
    rows.append(("moe_router", True, err,
                 time_ms(lambda: (MO.router_forward(x, w, b),
                                  MO.router_backward(x, pp, tp, dgate, w))),
                 time_ms(lambda: (MO.router_plain(x, w, b),
                                  MO.router_backward_plain(x, pp, tp, dgate, w))),
                 (N, H, Ex),
                 2 * N * H + 4 * (Ex * H + Ex) + 4 * N * Ex + 4 * N + 2 * N  # forward
                 + 2 * N * H + 4 * N * Ex + 4 * N + 2 * N + 4 * Ex * H  # backward: in
                 + 2 * N * H + 4 * (Ex * H + Ex),  # backward: dx, dw, db
                 6 * N * H * Ex + 34 * N * Ex))
    out_e = torch.randn((Ex, N, H), generator=g).to(DEVICE, torch.bfloat16)
    gr = torch.randn((N, H), generator=g).to(DEVICE, torch.bfloat16)
    if not torch.equal(MO.select_scale_forward(out_e, tk, gk), MO.select_scale_plain(out_e, tk, gk)):
        raise AssertionError("select-and-scale differs from its plain version")
    (dk, dgk), (dp, dgp) = (MO.select_scale_backward(out_e, tk, gk, gr),
                            MO.select_scale_backward_plain(out_e, tk, gk, gr))
    if not torch.equal(dk, dp):
        raise AssertionError("the experts' cotangent differs from the plain version's")
    rows.append(("moe_select", True, _step_close(dgk, dgp),
                 time_ms(lambda: (MO.select_scale_forward(out_e, tk, gk),
                                  MO.select_scale_backward(out_e, tk, gk, gr))),
                 time_ms(lambda: (MO.select_scale_plain(out_e, tk, gk),
                                  MO.select_scale_backward_plain(out_e, tk, gk, gr))),
                 (Ex, N, H),
                 (2 * N * H + 6 * N + 2 * N * H)  # forward: the chosen rows, top, gate
                 + (4 * N * H + 6 * N + 2 * Ex * N * H + 2 * N),  # backward
                 N * H + 2 * N * H))
    rows += loss_head_rows(g, library)
    grp = opt.groups[torch.bfloat16]
    p0 = grp.flat.detach().clone()
    grads = [(0.01 * torch.randn(p0.numel(), generator=g)).to(DEVICE, torch.bfloat16)
             for _ in range(3)]

    def adamw(update):
        p, mo, ve = p0.clone(), torch.zeros_like(p0), torch.zeros_like(p0)
        for i, gg in enumerate(grads, 1):
            update(p, gg, mo, ve, MOE_LR, 0.9, 0.999, 1e-8, 1e-4, 1 - 0.9 ** i, 1 - 0.999 ** i)
        return p, mo, ve
    err = 0.0
    for a, c in zip(adamw(optim.adamw_bf16_update), adamw(optim.adamw_bf16_update_plain)):
        torch.testing.assert_close(a.float(), c.float(), rtol=STEP, atol=1e-12)
        err = max(err, float((a.float() - c.float()).abs().max()))
    state = (p0.clone(), torch.zeros_like(p0), torch.zeros_like(p0))
    step_args = (MOE_LR, 0.9, 0.999, 1e-8, 1e-4, 0.1, 0.001)
    rows.append(("adamw_bf16", True, err,
                 time_ms(lambda: optim.adamw_bf16_update(state[0], grads[0], *state[1:],
                                                         *step_args)),
                 time_ms(lambda: optim.adamw_bf16_update_plain(state[0], grads[0], *state[1:],
                                                               *step_args)),
                 n_expert, 14 * n_expert, 25 * n_expert))
    steps_t = torch.ones((), device=DEVICE)
    library["adamw_bf16"] = time_ms(lambda: torch._fused_adamw_(
        [state[0]], [grads[0]], [state[1]], [state[2]], [], [steps_t], lr=MOE_LR, beta1=0.9,
        beta2=0.999, weight_decay=1e-4, eps=1e-8, amsgrad=False, maximize=False))
    rec = {"steps": MOE_STEPS, "pairs": MOE_B, "tokens": TRAIN_T, "experts": MOE_E,
           "expert_params": n_expert, "loss_first5": first, "loss_last5": last,
           "loss_kernels": losses_k, "loss_plain": losses_p, "curve_max_rel_diff": curve,
           "step_ms_kernels": step_ms["kernels"], "step_ms_plain": step_ms["plain"],
           "seconds": time.perf_counter() - t0,
           "launches": {k: launches[k] for k in MOE_KERNELS}}
    log(f"[moe] {json.dumps(rec)} card={card}")
    log(f"[moe] K15c's InfoNCE head beside F.cross_entropy and its gradient, its pair head "
        f"beside F.soft_margin_loss and its gradient (torch.autograd.grad; the undistilled "
        f"head), K15d beside torch._fused_adamw_ on the bf16 tensors (f32 math inside, one "
        f"rounding per tensor write: it rounds differently from optax's bf16 steps) "
        f"card={card}")
    del model, opt
    return {"record": rec, "rows": rows, "launches": launches, "library": library}


def pipeline_phase(card: str) -> dict:
    """The pipeline-parallel train step (parallel/pipeline.py, K16) at
    MiniLM-L6's width on a (pp=PIPE_S, dp=PIPE_DP) Mesh of entries of the
    one card: K16a-d held against their plain versions at the step's shapes
    (the attention backward against autograd of the plain forward) and timed
    beside a library call; pipeline_apply with the kernels against
    reference_forward through the plain versions; PIPE_STEPS SGD steps with
    the kernels (launch counts reset just before and read just after) and
    the same steps through the plain versions from the same parameters, the
    loss finite and the curves within PIPE_CURVE_RTOL; a step timed with
    each in turns. → {"record", "rows" (name, err, ms, plain ms, shape,
    bytes, ops), "launches", "library"}."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from stract_tpu_torch.ops import kernels
    from stract_tpu_torch.ops import stage as ST
    from stract_tpu_torch.parallel import pipeline as PL
    from stract_tpu_torch.parallel.mesh import Mesh

    t0 = time.perf_counter()
    dev = torch.device(DEVICE, 0)
    S, H, FF, T, D, M, MB = PIPE_S, PIPE_H, PIPE_F, PIPE_T, PIPE_DP, PIPE_M, PIPE_MB
    mb = MB // D
    mesh = Mesh([[dev] * D] * S, axis_names=("pp", "dp"))
    init_fn, step_fn = PL.make_pipeline_train_step(mesh, hidden=H, ffn=FF, learning_rate=PIPE_LR)
    start = PL.params_to_numpy(init_fn(SEED))
    n_params = sum(a.size for a in start.values())
    rng = np.random.default_rng(SEED + 10)
    mbs = torch.from_numpy(rng.normal(size=(M, MB, T, H)).astype(np.float32)).to(dev)
    targets = torch.from_numpy(rng.normal(size=(M, MB)).astype(np.float32)).to(dev)

    # K16a-d against their plain versions at the step's shapes (one dp shard's
    # microbatch), each beside a PyTorch call computing the same function
    rows, library = [], {}
    g = torch.Generator().manual_seed(SEED + 11)

    def close(got, want, rtol, atol) -> float:
        torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
        return float((got - want).abs().max())
    # K16a-b at the step's shape, then at T = 512 and at H = 1,024; each beside
    # SDPA in f32 and its backward
    sdpa_err = None
    for T_, H_ in ((T, H),) + PIPE_WIDE:
        qkv = torch.randn((mb, T_, 3 * H_), generator=g).to(dev)
        dout = torch.randn((mb, T_, H_), generator=g).to(dev)
        out_p = ST.stage_attention_plain(qkv)
        out_k = ST.stage_attention_forward(qkv)
        err = close(out_k, out_p, 1e-5, 1e-5 * float(out_p.abs().max()))
        if not torch.equal(ST.stage_attention_forward(qkv), out_k):
            raise AssertionError("two calls of the stage attention kernel differ")
        pairs = 2 * mb * T_ * T_ * H_  # one T x T x H product's flops
        rows.append(("stage_attention", err, time_ms(lambda: ST.stage_attention_forward(qkv)),
                     time_ms(lambda: ST.stage_attention_plain(qkv)), (mb, T_, H_),
                     4 * (3 + 1) * mb * T_ * H_, 3 * 2 * pairs, PEAK_TF32))
        leaf = qkv.clone().requires_grad_(True)
        (auto,) = torch.autograd.grad(ST.stage_attention_plain(leaf), leaf, dout)
        atol = 1e-5 * float(auto.abs().max())
        err = close(ST.stage_attention_backward(qkv, dout), auto, 1e-5, atol)
        close(ST.stage_attention_backward_plain(qkv, dout), auto, 1e-5, atol)
        if not torch.equal(ST.stage_attention_backward(qkv, dout),
                           ST.stage_attention_backward(qkv, dout)):
            raise AssertionError("two calls of the stage attention backward kernel differ")
        # qkv, dout read and dqkv written once (the kernel's P / dS scratch is
        # its own design, not the function's); five products, each three TF32
        rows.append(("stage_attention_backward", err,
                     time_ms(lambda: ST.stage_attention_backward(qkv, dout)),
                     time_ms(lambda: ST.stage_attention_backward_plain(qkv, dout)), (mb, T_, H_),
                     4 * (3 + 1 + 3) * mb * T_ * H_, 3 * 5 * pairs, PEAK_TF32))
        q, k, v = (qkv[..., i * H_:(i + 1) * H_].unsqueeze(1).contiguous().requires_grad_(True)
                   for i in range(3))
        lib_f = time_ms(lambda: F.scaled_dot_product_attention(q, k, v))
        o = F.scaled_dot_product_attention(q, k, v)
        do = dout.unsqueeze(1)
        lib_b = time_ms(lambda: torch.autograd.grad(o, (q, k, v), do, retain_graph=True))
        if sdpa_err is None:  # the step's shape: the kernels' library times
            library["stage_attention"], library["stage_attention_backward"] = lib_f, lib_b
            sdpa_err = float((o.detach().squeeze(1) - out_p).abs().max())
        log(f"[pipeline] K16a/K16b at mb={mb} T={T_} H={H_}: sdpa {lib_f:.4f} ms, its backward "
            f"{lib_b:.4f} ms")
        del o, q, k, v, leaf, auto

    # K16c at the step's shape (the main row), then at an odd length (single
    # elements) and on a view 4 bytes past a 16-byte boundary (the same)
    x = (3 * torch.randn((mb, T, FF), generator=g)).to(dev)
    dx = torch.randn((mb, T, FF), generator=g).to(dev)
    n = mb * T * FF
    odd, dodd = (3 * torch.randn(n + 1, generator=g)).to(dev), torch.randn(n + 1, generator=g)
    for shape, xv, gv in (((mb, T, FF), x, dx), ((n + 1,), odd, dodd.to(dev)),
                          (("view at +4 B", n), odd[1:], dx.reshape(-1))):
        atol = 1e-6 * float(xv.abs().max())
        err = max(close(ST.gelu_tanh_forward(xv), ST.gelu_tanh_plain(xv), 1e-5, atol),
                  close(ST.gelu_tanh_backward(xv, gv), ST.gelu_tanh_backward_plain(xv, gv),
                        1e-5, atol))
        nv = xv.numel()
        rows.append(("gelu_tanh", err,
                     time_ms(lambda: (ST.gelu_tanh_forward(xv), ST.gelu_tanh_backward(xv, gv))),
                     time_ms(lambda: (ST.gelu_tanh_plain(xv),
                                      ST.gelu_tanh_backward_plain(xv, gv))),
                     shape, 4 * (2 + 3) * nv, 34 * nv))
    xl = x.clone().requires_grad_(True)
    y = F.gelu(xl, approximate="tanh")
    library["gelu_tanh"] = time_ms(lambda: (F.gelu(x, approximate="tanh"),
                                            torch.autograd.grad(y, xl, dx, retain_graph=True)))

    ps = [torch.from_numpy(a).to(dev) for key in PL.STAGE_KEYS for a in start[key]]
    ps.append(torch.from_numpy(start["head"]).to(dev))
    gs = [0.01 * torch.randn(p.shape, generator=g).to(dev) for p in ps]

    def sgd(update):  # one call over all the step's tensors, as the step makes it
        out = [p.clone() for p in ps]
        for _ in range(3):
            update(out, gs, PIPE_LR)
        return out
    if not all(torch.equal(a, b) for a, b in zip(sgd(ST.sgd_update_many),
                                                 sgd(ST.sgd_update_many_plain))):
        raise AssertionError("the SGD kernel differs from its plain version")
    work = [p.clone() for p in ps]
    rows.append(("sgd", 0.0, time_ms(lambda: ST.sgd_update_many(work, gs, PIPE_LR)),
                 time_ms(lambda: ST.sgd_update_many_plain(work, gs, PIPE_LR)),
                 n_params, 12 * n_params, 2 * n_params))
    library["sgd"] = time_ms(lambda: torch._foreach_add_(work, gs, alpha=-PIPE_LR))
    del work, ps, gs

    # the pipelined forward against the sequential twin through the plain versions
    params = PL.params_from_numpy(start, mesh)
    with torch.no_grad():
        piped = PL.pipeline_apply(mesh, params, mbs)
        with plain_versions():
            seq = PL.reference_forward(params, mbs)
    if piped.shape != (M, MB, T, H) or not bool(torch.isfinite(piped).all()):
        raise AssertionError(f"the pipelined forward gave {tuple(piped.shape)}, finite="
                             f"{bool(torch.isfinite(piped).all())}")
    torch.testing.assert_close(piped, seq, rtol=PIPE_TOL[0], atol=PIPE_TOL[1])
    fwd_err = float((piped - seq).abs().max())
    del piped, seq, params

    # the train steps, with the kernels and through the plain versions
    def run():
        params = PL.params_from_numpy(start, mesh)
        torch.cuda.synchronize()
        kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        losses = [step_fn(params, mbs, targets)[1] for _ in range(PIPE_STEPS)]
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        return [float(v) for v in losses], launches, params, torch.cuda.max_memory_allocated()

    losses_k, launches, params, peak = run()
    with plain_versions():
        losses_p = run()[0]
    if not np.isfinite(losses_k).all():
        raise AssertionError(f"the pipelined steps gave a non-finite loss: {losses_k}")
    if any(launches[k] == 0 for k in PIPE_KERNELS):
        raise AssertionError(f"a kernel was not launched by the pipelined steps: {launches}")
    curve = max(abs(a - b) / abs(b) for a, b in zip(losses_k, losses_p))
    if curve > PIPE_CURVE_RTOL:
        raise AssertionError(f"pipelined loss curves differ by {curve:.3g} relative: {losses_k} "
                             f"vs {losses_p}")

    def timed():
        step_fn(params, mbs, targets)  # warm-up
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(PIPE_TIMED):
            step_fn(params, mbs, targets)
        torch.cuda.synchronize()
        return (time.perf_counter() - t1) * 1e3 / PIPE_TIMED
    step_ms = {"kernels": [], "plain": []}
    for kind in ("plain", "kernels", "kernels", "plain"):
        with plain_versions() if kind == "plain" else contextlib.nullcontext():
            step_ms[kind].append(timed())
    # the step's bound: each kernel's bound at the step's shape (the first
    # row of each above) times its launches a step (K16c's rows are a
    # forward + backward pair; K16d's covers every parameter once), the
    # stages' f32 weight products (four a stage forward, twice as many
    # backward, at the f32 peak: allow_tf32 is off) and the activations and
    # their gradients copied between stages (read and written once)
    first = {}
    for name, _, _, _, _, nb, ops, *pk in rows:
        first.setdefault(name, bound(nb, ops, *pk)[0])
    per_step = {k: launches[k] / PIPE_STEPS for k in PIPE_KERNELS}
    tokens = M * MB * T
    parts = {"stage_attention": per_step["stage_attention"] * first["stage_attention"],
             "stage_attention_backward": per_step["stage_attention_backward"]
             * first["stage_attention_backward"],
             "gelu_tanh": per_step["gelu_tanh"] / 2 * first["gelu_tanh"], "sgd": first["sgd"],
             "products": 1e3 * 3 * S * tokens * 2 * (4 * H * H + 2 * H * FF) / PEAK_F32,
             "copies": 1e3 * 2 * 2 * (S - 1) * tokens * H * 4 / PEAK_BYTES}
    rec = {"stages": S, "hidden": H, "ffn": FF, "tokens": T, "mesh": {"pp": S, "dp": D},
           "microbatches": M, "rows": MB, "params": int(n_params), "steps": PIPE_STEPS,
           "lr": PIPE_LR, "loss_kernels": losses_k, "loss_plain": losses_p,
           "curve_max_rel_diff": curve, "forward_max_abs_err": fwd_err,
           "step_ms_kernels": min(step_ms["kernels"]), "step_ms_plain": min(step_ms["plain"]),
           "launches_per_step": per_step, "step_bound_ms": sum(parts.values()),
           "step_bound_parts_ms": parts,
           "device_mem_peak_MiB": peak / 2 ** 20, "sdpa_max_abs_diff": sdpa_err,
           "seconds": time.perf_counter() - t0}
    log(f"[pipeline] {json.dumps(rec)} card={card}")
    del params
    return {"record": rec, "rows": rows, "launches": {k: launches[k] for k in PIPE_KERNELS},
            "library": library}


def hll_width_checks(g, dev) -> None:
    """K6a, K6b and K8 at HLL_PRECISIONS on graph g against their plain
    versions: three systolic rounds of K6a (registers and change bytes
    bit-equal to the plain merge and its twin, sizes within rel 1e-6 of the
    plain estimate and bit-equal to K6b alone on the same rows), then three
    systolic ring rounds over 3 shards (K8: registers, change bytes and flags
    bit-equal to the plain ring's, sizes rel 1e-6)."""
    import torch

    from stract_tpu_torch.ops import hll_ops as HO
    from stract_tpu_torch.webgraph import centrality as WC
    from stract_tpu_torch.webgraph import shortest_path as SP
    from stract_tpu_torch.webgraph.csr import graph_in_csr

    n = g.num_nodes
    ef, et = SP.forward_edges(g)
    csr = graph_in_csr(g, dev)
    eft, ett = torch.from_numpy(ef).to(dev), torch.from_numpy(et).to(dev)
    shards_n = 3
    S = -(-n // shards_n)
    buckets = {w: WC.ring_buckets(n, ef, et, [torch.device(w)] * shards_n) for w in (dev, "cpu")}
    for p in HLL_PRECISIONS:
        m, err = 1 << p, 0.0
        regs = torch.from_numpy(HO.init_registers(n, p)).to(dev)
        est, ref = HO.estimate_sizes(regs), HO.estimate_sizes_plain(regs)
        torch.testing.assert_close(est, ref, rtol=1e-6, atol=0)
        flags = torch.ones(n, dtype=torch.uint8, device=dev)
        for r in range(3):
            rows_out = torch.empty_like(flags)
            new, sizes, _ = HO.merge_csr(regs, csr, flags=flags, flags_out=rows_out)
            plain = HO.merge_iteration_plain(regs, eft, ett)
            twin, twin_rows = HO.merge_systolic_plain(regs, flags, eft, ett)
            if not (torch.equal(new, plain) and torch.equal(twin, plain)
                    and torch.equal(rows_out, twin_rows)):
                raise AssertionError(f"K6a at m = {m} differs from the plain merge, round {r + 1}")
            ref = HO.estimate_sizes_plain(plain)
            torch.testing.assert_close(sizes, ref, rtol=1e-6, atol=0)
            if not torch.equal(sizes, HO.estimate_sizes(new)):
                raise AssertionError(f"K6a's sizes at m = {m} are not K6b's bits")
            err = max(err, float(((sizes - ref).abs() / ref.abs()).max()))
            regs, flags = new, rows_out
        regs0 = torch.zeros((S * shards_n, m), dtype=torch.uint8)
        regs0[:n] = torch.from_numpy(HO.init_registers(n, p))
        shards = {w: [regs0[d * S:(d + 1) * S].to(w) for d in range(shards_n)]
                  for w in (dev, "cpu")}
        fl = {w: [torch.ones(S, dtype=torch.uint8, device=w) for _ in range(shards_n)]
              for w in (dev, "cpu")}
        for r in range(3):
            got, got_sz, got_ch, got_fl = WC.ring_round(shards[dev], buckets[dev], flags=fl[dev])
            want, _, want_ch, want_fl = WC.ring_round(shards["cpu"], buckets["cpu"],
                                                      flags=fl["cpu"])
            for a, b, sz, ca, cb, fa, fb in zip(got, want, got_sz, got_ch, want_ch, got_fl,
                                                want_fl):
                if not (torch.equal(a.cpu(), b) and torch.equal(fa.cpu(), fb)
                        and int(ca.item()) == int(cb.item())):
                    raise AssertionError(f"K8 at m = {m} differs from the plain ring, round "
                                         f"{r + 1}")
                torch.testing.assert_close(sz.cpu(), HO.estimate_sizes_plain(b), rtol=1e-6,
                                           atol=0)
            shards, fl = {dev: got, "cpu": want}, {dev: got_fl, "cpu": want_fl}
        log(f"[centrality] K6a / K6b / K8 at {m} registers a row ({n} nodes): registers and "
            f"change bytes bit-equal to plain, K6a's sizes K6b's bits, sizes max rel {err:.2g}")


def centrality_phase(data_dir: str) -> dict:
    """The webgraph centrality job: the benchmark graph (1M nodes, 20M
    Pareto edges, seed 0) written to disk, then `main.py centrality
    harmonic` and `approx-harmonic` (256 sources) on the card through the
    function the command line calls, launch counts reset just before each
    and read just after; each result checked (every node, finite, the kv
    store holds it) and, on a 2,000-node graph of the same recipe, held to
    the same job on the CPU. Then K6a, K6b and K7 against their plain
    versions at the job's shapes: K6a in the systolic rounds the job runs
    (registers bit-equal to the full plain merge and to the systolic twin,
    change bytes to the plain comparison, sizes within rel 1e-6), timed from
    round 3's registers with every change byte set and with round 3's bytes
    (the fourth round); distances bit-equal round by round; the whole
    HyperBall and the whole 256-source BFS through the plain versions: the
    same round count, centrality within rtol 1e-6, distances equal; K7 at
    1,100 sources on a 100,000-node graph of the same recipe, round by round
    against the relaxation; K6a, K6b and K8 at HLL_PRECISIONS on the
    2,000-node graph (hll_width_checks). → {"jobs", "rows", "graph_s", "graph"}; rows
    (name, err, ms, plain ms, shape, bytes, ops)."""
    import numpy as np
    import torch

    from stract_tpu_torch.entrypoint import bench_centrality as BC
    from stract_tpu_torch.kv import Db
    from stract_tpu_torch.main import run_centrality
    from stract_tpu_torch.ops import hll_ops as HO
    from stract_tpu_torch.ops import kernels
    from stract_tpu_torch.webgraph import centrality as WC
    from stract_tpu_torch.webgraph import shortest_path as SP
    from stract_tpu_torch.webgraph.csr import graph_in_csr

    def job_config(graph_dir: str, name: str) -> str:
        """A CentralityConfig TOML for the graph, its kv store cleared."""
        shutil.rmtree(os.path.join(data_dir, f"{name}-kv"), ignore_errors=True)
        path = os.path.join(data_dir, f"{name}.toml")
        with open(path, "w") as fh:
            fh.write(f'webgraph_path = "{graph_dir}"\noutput_path = "{data_dir}/{name}-kv"\n'
                     f"precision = 6\nnum_samples = {GRAPH_SAMPLES}\n")
        return path

    # a small graph of the same recipe: the card's job against the CPU's
    small = BC.write_bench_graph(os.path.join(data_dir, "graph-2000"), 2000, 40_000)
    for mode in ("harmonic", "approx-harmonic"):
        tc, tp = {}, {}
        on = run_centrality(mode, job_config(small.path, f"small-{mode}"), DEVICE, timings=tc)
        ref = run_centrality(mode, job_config(small.path, f"small-cpu-{mode}"), "cpu",
                             timings=tp)
        if tc["n_rounds"] != tp["n_rounds"] or list(on) != list(ref):
            raise AssertionError(f"{mode} on the card and the CPU differ: {tc} {tp}")
        np.testing.assert_allclose([on[k] for k in ref], list(ref.values()), rtol=1e-6,
                                   atol=1e-12)

    t0 = time.perf_counter()
    g = BC.write_bench_graph(os.path.join(data_dir, "graph"), GRAPH_NODES, GRAPH_EDGES)
    graph_s = time.perf_counter() - t0
    log(f"[centrality] graph of {g.num_nodes} nodes, {g.num_edges} edges on disk in "
        f"{graph_s:.1f}s")
    jobs = {}
    for mode, expect in (("harmonic", ("hll_merge", "hll_estimate")),
                         ("approx-harmonic", ("bfs_relax",))):
        cfg, timings = job_config(g.path, f"job-{mode}"), {}
        kernels.reset_launches()
        t0 = time.perf_counter()
        c = run_centrality(mode, cfg, DEVICE, timings=timings)
        seconds = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        vals = np.fromiter(c.values(), np.float64, len(c))
        if len(c) != g.num_nodes or not np.isfinite(vals).all() or vals.min() < 0 or \
                vals.max() <= 0:
            raise AssertionError(f"{mode}: {len(c)} values, range {vals.min()}..{vals.max()}")
        db = Db.open(os.path.join(data_dir, f"job-{mode}-kv"))
        name = g.name_of(int(np.argmax(vals)))
        if len(db) != g.num_nodes or db.get(name.encode())["centrality"] != c[name]:
            raise AssertionError(f"{mode}: the kv store does not hold the result")
        if any(launches[k] == 0 for k in expect):
            raise AssertionError(f"{mode}: a kernel was not launched by the job: {launches}")
        jobs[mode] = {"seconds": seconds, "timings": timings, "launches": launches,
                      "top": name, "top_value": float(vals.max()), "values": c}
        log(f"[centrality] {mode}: {seconds:.2f}s {json.dumps(timings)} launches "
            f"{ {k: launches[k] for k in expect} } card={card_line()}")

    dev = torch.device(DEVICE)
    n, e = g.num_nodes, g.num_edges
    ef, et = SP.forward_edges(g)
    csr = graph_in_csr(g, dev)
    eft, ett = torch.from_numpy(ef).to(dev), torch.from_numpy(et).to(dev)
    rows = []

    # K6a (+K6b in its epilogue) in the systolic rounds the job runs (every
    # change byte set before round 1), then timed from round 3's registers two
    # ways: every byte set (round 1's work, the full merge: like for like with
    # the earlier body) and round 3's change bytes (the fourth round); K6b alone
    regs = torch.from_numpy(HO.init_registers(n, 6)).to(dev)
    m = regs.shape[1]
    flags = torch.ones(n, dtype=torch.uint8, device=dev)
    sizes_err = 0.0
    for r in range(3):
        rows_out = torch.empty_like(flags)
        new, sizes, changed = HO.merge_csr(regs, csr, flags=flags, flags_out=rows_out)
        plain = HO.merge_iteration_plain(regs, eft, ett)
        twin, twin_rows = HO.merge_systolic_plain(regs, flags, eft, ett)
        ref = HO.estimate_sizes_plain(plain)
        if not (torch.equal(new, plain) and torch.equal(twin, plain)) or \
                not torch.equal(rows_out, twin_rows) or \
                int(changed.item()) != int(not torch.equal(plain, regs)):
            raise AssertionError(f"K6a differs from the plain merge in round {r + 1}")
        torch.testing.assert_close(sizes, ref, rtol=1e-6, atol=0)
        sizes_err = max(sizes_err, float(((sizes - ref).abs() / ref.abs()).max()))
        regs, flags = new, rows_out
    spare, spare_rows = torch.empty_like(regs), torch.empty_like(flags)
    plain = HO.merge_iteration_plain(regs, eft, ett)
    src_rows = csr.sources.long()
    for name, fl in (("every byte set", torch.ones_like(flags)), ("round 3's bytes", flags)):
        flagged = int(fl[src_rows].sum())
        ms = time_ms(lambda: HO.merge_csr(regs, csr, out=spare, flags=fl, flags_out=spare_rows))
        plain_ms = time_ms(lambda: HO.merge_systolic_plain(regs, fl, eft, ett), iters=3)
        if not torch.equal(spare, plain) or not torch.equal(spare_rows, (plain != regs).any(1)
                                                            .to(torch.uint8)):
            raise AssertionError(f"K6a with {name} differs from the full plain merge")
        log(f"[centrality] K6a from round 3's registers, {name}: {flagged} of {e} edges flagged "
            f"(share {flagged / e:.3f}), gather {m * flagged} B, {ms:.3f} ms")
        # bytes once: registers in and out, the CSR, change bytes in and out,
        # sizes, the flag; the gather (m B a flagged edge) is in the shape
        rows.append(("hll_merge", sizes_err, ms, plain_ms, (n, m, e, flagged),
                     2 * n * m + 4 * (n + 1) + 4 * e + 4 * csr.long_rows.numel() + 2 * n
                     + 4 * n + 4, flagged * m + 3 * n * m))
    est, ref = HO.estimate_sizes(regs), HO.estimate_sizes_plain(regs)
    torch.testing.assert_close(est, ref, rtol=1e-6, atol=0)
    rows.append(("hll_estimate", float(((est - ref).abs() / ref.abs()).max()),
                 time_ms(lambda: HO.estimate_sizes(regs)),
                 time_ms(lambda: HO.estimate_sizes_plain(regs)), (n, m), n * m + 4 * n,
                 3 * n * m))

    hll_width_checks(small, dev)

    # the whole HyperBall through the kernels and through the plain versions
    hb = {}
    for plain_run in (False, True):
        t = {}
        with plain_versions() if plain_run else contextlib.nullcontext():
            hb[plain_run] = (WC._hyperball(n, ef, et, 6, 64, DEVICE, timings=t, csr=csr), t)
    (acc_k, t_k), (acc_p, t_p) = hb[False], hb[True]
    if t_k["n_rounds"] != t_p["n_rounds"]:
        raise AssertionError(f"HyperBall rounds differ: {t_k['n_rounds']} vs {t_p['n_rounds']}")
    np.testing.assert_allclose(acc_k, acc_p, rtol=1e-6, atol=1e-12)
    log(f"[centrality] whole HyperBall, kernels vs plain: {t_k['n_rounds']} rounds each, "
        f"rounds {t_k['rounds']:.3f}s vs {t_p['rounds']:.3f}s, max rel diff "
        f"{float(np.max(np.abs(acc_k - acc_p) / np.maximum(np.abs(acc_p), 1e-300))):.3g}")

    # K7 at S = GRAPH_SAMPLES and S = 1, round by round from the sampled sources:
    # the frontier step's distances bit-equal to the reference's relaxation
    # (relax_plain) and its changed flag equal, its whole state bit-equal to
    # its plain twin's; then timed at the fourth round (level 3), seen put
    # back before each call (the step updates it in place), so every call does
    # that round's work and writes its distances
    sources = np.random.default_rng(0).choice(n, size=GRAPH_SAMPLES, replace=False)
    for S in (GRAPH_SAMPLES, 1):
        state = SP.bfs_start(n, sources[:S], dev)
        dist = state.dist[:, :S].t().contiguous()  # the reference's [S, N] layout
        for level in range(4):
            twin, twin_changed = SP.frontier_step_plain(state, eft, ett, level)
            if level == 3:
                break
            ref = SP.relax_plain(dist, eft, ett)
            new, changed = SP.frontier_step(state, csr, level)
            if not (torch.equal(new.dist[:, :S].t(), ref) and torch.equal(new.dist, twin.dist)
                    and torch.equal(new.seen, twin.seen)
                    and torch.equal(new.frontier, twin.frontier)) or \
                    int(changed.item()) != int(not torch.equal(ref, dist)) or \
                    int(changed.item()) != int(twin_changed.item()):
                raise AssertionError(f"K7 differs from the relaxation at S={S}, round {level}")
            state, dist = new, ref
        written = int((twin.dist != state.dist).sum())
        W = state.seen.shape[1]
        seen0, spare = state.seen.clone(), torch.empty_like(state.frontier)
        plain_ms = time_ms(lambda: SP.frontier_step_plain(state, eft, ett, 3), iters=3)
        ms = time_reset_ms(lambda: SP.frontier_step(state, csr, 3, out=spare),
                           lambda: state.seen.copy_(seen0))
        if not (torch.equal(state.dist, twin.dist) and torch.equal(spare, twin.frontier)):
            raise AssertionError(f"K7's timed calls differ from the plain step at S={S}")
        log(f"[centrality] K7 at S={S}, round 3: {written} distances written")
        rows.append(("bfs_relax", 0.0, ms, plain_ms, (n, S, e),
                     3 * 4 * n * W + 4 * (n + 1) + 4 * e + 4 * csr.long_rows.numel()
                     + 4 * written + 4, e * W + 3 * n * W))
    t_k, t_p = {}, {}
    d_k = SP.bfs(n, ef, et, sources, device=DEVICE, csr=csr, timings=t_k)
    with plain_versions():
        d_p = SP.bfs(n, ef, et, sources, device=DEVICE, csr=csr, timings=t_p)
    if t_k["n_rounds"] != t_p["n_rounds"] or not np.array_equal(d_k, d_p):
        raise AssertionError("the 256-source BFS through K7 and through the plain version differ")
    log(f"[centrality] whole {GRAPH_SAMPLES}-source BFS, kernels vs plain: {t_k['n_rounds']} "
        f"rounds each, rounds {t_k['rounds']:.3f}s vs {t_p['rounds']:.3f}s, distances equal "
        f"card={card_line()}")

    # K7 past 256 sources: 1,100 (W = 35 words a node, 32 lanes a row over two
    # chunks of words) on a 100,000-node graph of the same recipe, round by
    # round from sampled sources against the relaxation and the plain step
    g9 = BC.write_bench_graph(os.path.join(data_dir, "graph-100000"), 100_000, 2_000_000)
    ef9, et9 = (torch.from_numpy(a).to(dev) for a in SP.forward_edges(g9))
    csr9 = graph_in_csr(g9, dev)
    state = SP.bfs_start(g9.num_nodes, np.random.default_rng(1).choice(
        g9.num_nodes, size=WIDE_SAMPLES, replace=False), dev)
    dist = state.dist[:, :WIDE_SAMPLES].t().contiguous()
    for level in range(4):
        twin, twin_changed = SP.frontier_step_plain(state, ef9, et9, level)
        ref = SP.relax_plain(dist, ef9, et9)
        new, changed = SP.frontier_step(state, csr9, level)
        if not (torch.equal(new.dist[:, :WIDE_SAMPLES].t(), ref)
                and all(torch.equal(a, b) for a, b in zip(new, twin))) or \
                int(changed.item()) != int(twin_changed.item()) or \
                int(changed.item()) != int(not torch.equal(ref, dist)):
            raise AssertionError(f"K7 differs from the relaxation at S={WIDE_SAMPLES}, round "
                                 f"{level}")
        state, dist = new, ref
    log(f"[centrality] K7 at S={WIDE_SAMPLES} on {g9.num_nodes} nodes, {g9.num_edges} edges: 4 "
        f"rounds bit-equal to the relaxation, "
        f"{int((dist < int(SP.UNREACHABLE)).sum())} distances finite")
    del state, dist, twin, ref, new
    return {"jobs": jobs, "rows": rows, "graph_s": graph_s, "graph": g.path}


def start_mesh_corpus(data_dir: str):
    """Write the mesh's corpus (MESH_SHARDS segments of MESH_DOCS pages, seeds
    MESH_SEEDS, one index_meta.json) in a child process, a writer per
    segment, while the main corpus is built → the Popen (mesh_corpus reads
    it)."""
    code = (f"import sys\nsys.path.insert(0, {ROOT!r})\n"
            "from stract_tpu_torch import bench_corpus as bc\n"
            f"print(bc.ensure_segmented_corpus({data_dir!r}, {[MESH_DOCS] * MESH_SHARDS}, "
            f"{list(MESH_SEEDS)}, workers={MESH_SHARDS}))\n")
    return subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def mesh_corpus(proc) -> str:
    """Wait for start_mesh_corpus's child → the index directory."""
    out, _ = proc.communicate(timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"the mesh corpus was not written:\n{out[-2000:]}")
    return out.strip().splitlines()[-1]


def gathered(B: int, n: int, K: int, seed: int):
    """Per-shard top-K lists of B queries gathered shard-major, on the card
    → (scores f32[B, n, K], docs i32[B, n, K]): each list descending on a
    coarse grid (ties across and within shards), with a -inf tail (a shard
    with fewer matches than K); the last shard of query 0 all -inf."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    scores = np.sort(rng.integers(0, 64, (B, n, K)).astype(np.float32) / 4, axis=2)[..., ::-1]
    scores = np.ascontiguousarray(scores)
    tails = rng.integers(K // 4, K + 1, (B, n))
    for b in range(B):
        for d in range(n):
            scores[b, d, tails[b, d]:] = -np.inf
    scores[0, -1, :] = -np.inf
    docs = rng.integers(0, MESH_DOCS, (B, n, K)).astype(np.int32)
    return torch.from_numpy(scores).to(DEVICE), torch.from_numpy(docs).to(DEVICE)


def topk_library(scores, docs, K: int):
    """K9's library call on its inputs: torch.topk over each query's
    flattened n*K scores, then the docs gathered by the indices and the
    shard of each (index // K), the three outputs K9 returns (torch.topk
    does not promise lax.top_k's tie order: a timing only). → the function
    to time."""
    import torch

    B, n, _ = scores.shape
    flat, flat_docs = scores.view(B, n * K), docs.view(B, n * K)

    def run():
        vals, idx = torch.topk(flat, K)
        return torch.gather(flat_docs, 1, idx), torch.div(idx, K, rounding_mode="floor"), vals
    return run


def mesh_topk_rows() -> tuple:
    """K9 against its plain version (a stable sort: lax.top_k's order) at
    MESH_TOPK_SHAPES, B = MESH_TOPK_B queries, called as the mesh's merge
    calls it (each shard's [B, K] list where it lies: mesh_topk_lists) and
    stacked: docs, shards and scores bit-equal, every query in the merge
    form; timed (the per-shard call) beside torch.topk and the gathers
    (topk_library). Then at MESH_TOPK_SHAPES[1] with one list of query 3
    out of order: that query takes the select form, the others the merge,
    in one launch, bit-equal. → (rows (name, err, ms, plain ms, (n, K, B),
    bytes, ops), library ms at the first shape)."""
    import torch

    from stract_tpu_torch.ops import kernels
    from stract_tpu_torch.ops import scoring as O

    rows, library = [], None
    B = MESH_TOPK_B
    for i, (n, K) in enumerate(MESH_TOPK_SHAPES):
        scores, docs = gathered(B, n, K, SEED + 20 + i)
        s_l = [scores[:, j].contiguous() for j in range(n)]
        d_l = [docs[:, j].contiguous() for j in range(n)]
        forms = torch.full((B,), -1, dtype=torch.int32, device=DEVICE)
        run_k = lambda: O.mesh_topk_lists(s_l, d_l, K)  # noqa: E731
        run_p = lambda: O.mesh_topk_plain(scores, docs, K)  # noqa: E731
        for got in (O.mesh_topk_lists(s_l, d_l, K, forms), O.mesh_topk(scores, docs, K)):
            for a, b in zip(got, run_p()):
                if not torch.equal(a, b):
                    raise AssertionError(f"K9 differs from its plain version at n={n} K={K}")
        if forms.tolist() != [0] * B:
            raise AssertionError(f"K9 took the select form on sorted lists: {forms.tolist()}")
        lib = time_ms(topk_library(scores, docs, K))
        library = library if library is not None else lib
        rows.append(("mesh_topk", 0.0, time_ms(run_k), time_ms(run_p), (n, K, B),
                     8 * B * n * K + 12 * B * K, B * n * K))
        log(f"[mesh] K9 n={n} K={K} B={B}: bit-equal to the plain version, per shard and "
            f"stacked, every query merged; per-shard {rows[-1][2]:.4f} ms, stacked "
            f"{time_ms(lambda: O.mesh_topk(scores, docs, K)):.4f} ms; torch.topk and the "
            f"docs' and shards' gathers {lib:.4f} ms (torch.topk keeps no set tie order)")
    n, K = MESH_TOPK_SHAPES[1]
    scores, docs = gathered(B, n, K, SEED + 29)
    scores[3, 2, K - 1] = 100.0  # query 3's list 2 out of order
    s_l = [scores[:, j].contiguous() for j in range(n)]
    d_l = [docs[:, j].contiguous() for j in range(n)]
    forms = torch.full((B,), -1, dtype=torch.int32, device=DEVICE)
    kernels.reset_launches()
    got = O.mesh_topk_lists(s_l, d_l, K, forms)
    torch.cuda.synchronize()
    if kernels.LAUNCHES["mesh_topk"] != 1:
        raise AssertionError(f"K9 launched {kernels.LAUNCHES['mesh_topk']} times for one call")
    for a, b in zip(got, O.mesh_topk_plain(scores, docs, K)):
        if not torch.equal(a, b):
            raise AssertionError("K9 with a list out of order differs from its plain version")
    if forms.tolist() != [int(b == 3) for b in range(B)]:
        raise AssertionError(f"K9's forms with query 3 out of order: {forms.tolist()}")
    log(f"[mesh] K9 n={n} K={K} B={B} with one list out of order: one launch, query 3 in the "
        f"select form and {B - 1} merged, bit-equal to the plain version")
    return rows, library


def mesh_serve_phase(index_dir: str, card: str) -> dict:
    """The mesh's serving path: the 4-segment index served by a search shard
    (entrypoint/search_server.py run) on a mesh of MESH_SHARDS entries on the
    card, over sonic, with the coordinator (entrypoint/api.py, found by
    gossip) and the HTTP server in front; one round of the request mix,
    counts reset just before and read just after; every request answered and
    K1, the joined stage B, pass 2 and K9 launched. Then the same index
    without a mesh (build_searcher: per segment on the card) serves the same
    round, and the 8 compare queries are held between the two: pass 1's
    top-10 candidates (stage B's exact scores) within rtol 1e-5 with docs
    equal up to ties, and the top-10 pages within PAGE_RTOL (their scores
    come from q16 signal rows: the shard's eager pass 2 against the lazy
    page materialisation, as the configurations'). K9 must have been called
    per shard (its lists where they lie), never stacked. → record."""
    import numpy as np
    import torch

    from stract_tpu_torch.config import ApiConfig
    from stract_tpu_torch.entrypoint import search_server
    from stract_tpu_torch.entrypoint.api import build_coordinator
    from stract_tpu_torch.main import build_searcher
    from stract_tpu_torch.ops import kernels
    from stract_tpu_torch.parallel.mesh import Mesh
    from stract_tpu_torch.searcher.query import SearchQuery

    mesh = Mesh([torch.device(DEVICE, 0)] * MESH_SHARDS, axis_names=("x",))
    t0 = time.perf_counter()
    server, shard_cluster = search_server.run(index_dir, 0, mesh=mesh, device=DEVICE)
    svc = server.server.service
    api_cluster = None
    try:
        sharded = svc.searcher._sharded
        if sharded is None or sharded.n != MESH_SHARDS or len(sharded._segments) != MESH_SHARDS:
            raise AssertionError("the shard server did not take the mesh path")
        host, port = shard_cluster.gossip_addr
        api, api_cluster, _pages = build_coordinator(
            ApiConfig(gossip={"addr": "127.0.0.1:0", "seeds": [f"{host}:{port}"]}), DEVICE)
        if api_cluster.await_member(lambda m: m.service.kind == "search-server",
                                    timeout=30) is None:
            raise AssertionError("the coordinator did not find the shard server")
        setup_s = time.perf_counter() - t0
        served = serve_phase(api, MESH_SERVING)
        calls = dict(kernels.MESH_TOPK_CALLS)
        if calls["stacked"] or not calls["lists"]:
            raise AssertionError(f"the mesh's merge called K9 as {calls}, not per shard")
        stats = dict(sharded.stats)
        log(f"[mesh serve] {json.dumps(served)} card={card}")
        bodies = compare_bodies()
        mesh_pages = top10_pages(api)
        mesh_cands = svc.searcher.search_initial_many(
            [SearchQuery.from_json(b) for b in bodies], 10)
    finally:
        if api_cluster is not None:
            api.searcher.client.close()  # the shard's handlers end before its loop stops
            api_cluster.shutdown()
        shard_cluster.shutdown()
        server.stop()
        svc.searcher.batcher.stop()
    del svc, server
    torch.cuda.empty_cache()

    ref = build_searcher(index_dir, DEVICE)
    # the per-segment path's pages take their rows from stage B's fused rows
    # here, so pass 2 may not run
    served_ref = serve_phase(ref, ("stage_a", "stage_b"))
    ref_pages = top10_pages(ref)
    ref_cands = ref.searcher.searchers[0].search_initial_many(
        [SearchQuery.from_json(b) for b in bodies], 10)
    del ref
    torch.cuda.empty_cache()
    cand_err, page_err, n_docs = 0.0, 0.0, 0
    for body, (cm, nm), (cr, nr), wm, wr in zip(bodies, mesh_cands, ref_cands, mesh_pages,
                                                ref_pages):
        if len(cm) != len(cr) or nm.to_json() != nr.to_json():
            raise AssertionError(f"the mesh's pass 1 differs on {body}: {len(cm)} vs {len(cr)}")
        ids = lambda cs: np.array([c.pointer.segment << 32 | c.pointer.doc  # noqa: E731
                                   for c in cs], dtype=np.int64)
        if cm:
            cand_err = max(cand_err, topk_match(
                ids(cr), np.array([c.score for c in cr]), ids(cm),
                np.array([c.score for c in cm]), -1, MESH_TOL, 0.0))
            np.testing.assert_allclose([c.score for c in cm], [c.score for c in cr],
                                       rtol=MESH_TOL)
        diff = page_diff(wm, wr, PAGE_RTOL)
        if diff is None:
            raise AssertionError(f"the mesh's top-10 page differs on {body}")
        page_err, n_docs = max(page_err, diff), n_docs + len(wm)
    if n_docs == 0:
        raise AssertionError("the compared queries returned nothing")
    return {"docs": MESH_DOCS * MESH_SHARDS, "shards": MESH_SHARDS, "setup_s": setup_s,
            "qps": served["qps"], "p50_ms": served["p50_ms"], "p99_ms": served["p99_ms"],
            "failed": served["failed"], "requests": served["requests"],
            "launches": served["launches"], "mesh_topk_calls": calls,
            "driver_share": stats["driver"] / max(stats["queries"], 1), "shard_stats": stats,
            "unsharded_qps": served_ref["qps"], "unsharded_p50_ms": served_ref["p50_ms"],
            "unsharded_p99_ms": served_ref["p99_ms"], "compared": len(bodies),
            "top10_docs": n_docs, "pass1_max_score_diff": cand_err,
            "page_max_score_diff": page_err}


def mesh_centrality_phase(data_dir: str, cent: dict, card: str) -> dict:
    """The centrality job on a mesh of MESH_SHARDS entries on the card, over
    the centrality phase's graph (1M nodes, 20M edges): run_harmonic(mesh=),
    counts reset just before and read just after (K8 and K6b launched); the
    same rounds as the single-card job and its centrality within rtol 1e-5.
    Then the rounds again, both systolic, ring against K6a from the same
    registers: every round's registers and change bytes bit-equal and the
    change flags equal. Then K8 on one (shard, step) bucket from round 3's
    registers, with every change byte set and with round 3's bytes, against
    the plain step: the rows bit-equal; and its last step's change flag,
    change bytes and sizes (rel 1e-6). → {"record", "rows", "launches"};
    rows as centrality_phase's."""
    import numpy as np
    import torch

    from stract_tpu_torch.entrypoint.centrality import run_harmonic
    from stract_tpu_torch.ops import hll_ops as HO
    from stract_tpu_torch.ops import kernels
    from stract_tpu_torch.parallel.mesh import Mesh
    from stract_tpu_torch.webgraph import Webgraph
    from stract_tpu_torch.webgraph import centrality as WC
    from stract_tpu_torch.webgraph import shortest_path as SP
    from stract_tpu_torch.webgraph.csr import graph_in_csr

    dev = torch.device(DEVICE)
    mesh = Mesh([dev] * MESH_SHARDS, axis_names=("x",))
    single = cent["jobs"]["harmonic"]
    timings = {}
    kernels.reset_launches()
    t0 = time.perf_counter()
    c = run_harmonic(cent["graph"], os.path.join(data_dir, "mesh-kv"), 6, DEVICE,
                     timings=timings, mesh=mesh)
    seconds = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    if launches["hll_ring_step"] == 0 or launches["hll_estimate"] == 0:
        raise AssertionError(f"the mesh's HyperBall did not launch K8 and K6b: {launches}")
    if timings["n_rounds"] != single["timings"]["n_rounds"] or list(c) != list(single["values"]):
        raise AssertionError(f"mesh rounds {timings['n_rounds']} vs "
                             f"{single['timings']['n_rounds']}")
    ref = single["values"]
    np.testing.assert_allclose([c[k] for k in ref], list(ref.values()), rtol=1e-5, atol=1e-9)
    cent_err = float(max(abs(c[k] - v) / max(abs(v), 1e-300) for k, v in ref.items()))
    stage = {k: timings[k] for k in ("bucket", "setup", "estimate", "rounds", "n_rounds")}
    log(f"[mesh centrality] {MESH_SHARDS} shards: {seconds:.2f}s, stages {json.dumps(stage)} "
        f"launches { {k: launches[k] for k in ('hll_ring_step', 'hll_estimate')} } "
        f"centrality max rel diff vs single card {cent_err:.3g} card={card}")

    # the rounds again, both systolic (every change byte set before round 1):
    # the ring against K6a, register for register and change byte for change
    # byte, the change flags equal
    g = Webgraph(cent["graph"])
    n = g.num_nodes
    ef, et = SP.forward_edges(g)
    csr = graph_in_csr(g, dev)
    t1 = time.perf_counter()
    buckets = WC.ring_buckets(n, ef, et, [dev] * MESH_SHARDS)
    S = -(-n // MESH_SHARDS)
    regs0 = np.zeros((S * MESH_SHARDS, 64), np.uint8)
    regs0[:n] = HO.init_registers(n, 6)
    regs = torch.from_numpy(regs0[:n]).to(dev)
    shards = [torch.from_numpy(regs0[d * S:(d + 1) * S]).to(dev) for d in range(MESH_SHARDS)]
    flags = torch.ones(n, dtype=torch.uint8, device=dev)
    shard_flags = [torch.ones(S, dtype=torch.uint8, device=dev) for _ in range(MESH_SHARDS)]
    spare, spare_flags = torch.empty_like(regs), torch.empty_like(flags)
    rounds = 0
    while True:
        new, _, changed = HO.merge_csr(regs, csr, out=spare, sizes=False, flags=flags,
                                       flags_out=spare_flags)
        nsh, _, ch, nfl = WC.ring_round(shards, buckets, sizes=False, flags=shard_flags)
        if not torch.equal(torch.cat(nsh)[:n], new):
            raise AssertionError(f"the ring's registers differ from K6a's after round {rounds + 1}")
        if not torch.equal(torch.cat(nfl)[:n], spare_flags):
            raise AssertionError(f"the ring's change bytes differ from K6a's in round {rounds + 1}")
        if int(changed.item()) != int(any(int(x.item()) for x in ch)):
            raise AssertionError("the ring's change flag differs from K6a's")
        if not int(changed.item()):
            break
        rounds += 1
        regs, spare, shards = new, regs, nsh
        flags, spare_flags, shard_flags = spare_flags, flags, nfl
        if rounds == 3:  # the state K8 is read from
            at3 = [t.clone() for t in shards], [f.clone() for f in shard_flags]
    if rounds != timings["n_rounds"]:
        raise AssertionError(f"{rounds} register rounds vs the job's {timings['n_rounds']}")
    log(f"[mesh centrality] {rounds} rounds, the ring's registers and change bytes bit-equal to "
        f"K6a's after each ({time.perf_counter() - t1:.1f}s)")

    # K8 alone on one (shard, step) bucket: its last step from the initial
    # registers, then timed from round 3's registers with every change byte
    # set and with round 3's bytes (the fourth round's step)
    bucket = buckets[0][1]
    E, m = int(bucket.sources.numel()), 64
    rows_init = torch.from_numpy(regs0[:S]).to(dev)
    buf0 = torch.from_numpy(regs0[S:2 * S]).to(dev)
    out_k, out_p = rows_init.clone(), rows_init.clone()
    rows_k = torch.empty(S, dtype=torch.uint8, device=dev)
    ch_k, sz_k = HO.ring_step(out_k, buf0, bucket, start=rows_init, sizes=True, flags_out=rows_k)
    HO.ring_step_plain(out_p, buf0, bucket)
    sz_p = HO.estimate_sizes_plain(out_p)
    if not torch.equal(out_k, out_p) or int(ch_k.item()) != int(not torch.equal(out_p, rows_init)) \
            or not torch.equal(rows_k, (out_p != rows_init).any(1).to(torch.uint8)):
        raise AssertionError("K8's last step differs from its plain version")
    torch.testing.assert_close(sz_k, sz_p, rtol=1e-6, atol=0)
    err = float(((sz_k - sz_p).abs() / sz_p.abs()).max())
    start, buf = at3[0][0], at3[0][1]
    want = HO.ring_step_plain(start.clone(), buf, bucket)
    src_rows, tgt_rows = bucket.sources.long(), SP.csr_targets(bucket)
    rows = []
    for name, fl in (("every byte set", torch.ones(S, dtype=torch.uint8, device=dev)),
                     ("round 3's bytes", at3[1][1])):
        out_k = start.clone()
        HO.ring_step(out_k, buf, bucket, flags=fl)
        if not (torch.equal(out_k, want)
                and torch.equal(HO.ring_step_plain(start.clone(), buf, bucket, fl), want)):
            raise AssertionError(f"K8 with {name} differs from the full plain step")
        keep = fl[src_rows] != 0
        flagged = int(keep.sum())
        out_t = start.clone()
        ms = time_ms(lambda: HO.ring_step(out_t, buf, bucket, flags=fl))
        plain_ms = time_ms(lambda: HO.ring_step_plain(out_t, buf, bucket, fl), iters=3)
        # bytes once: the CSR, the change bytes, each target row that gathers
        # read and written, each flagged source row read
        gathered, sources = (int(torch.unique(x[keep]).numel()) for x in (tgt_rows, src_rows))
        log(f"[mesh centrality] K8 on bucket (0, 1), {name}: {flagged} of {E} edges flagged "
            f"(share {flagged / E:.3f}), gather {m * flagged} B, {ms:.3f} ms")
        rows.append(("hll_ring_step", err, ms, plain_ms, (S, m, E, flagged),
                     4 * (S + 1) + 4 * E + 4 * bucket.long_rows.numel() + S
                     + m * (2 * gathered + sources), flagged * m))
    log(f"[mesh centrality] K8 on bucket (0, 1): {S} rows, {E} edges, bit-equal to the plain "
        f"version; last step's sizes max rel diff {err:.3g}")
    record = {"shards": MESH_SHARDS, "seconds": seconds, "stages": stage,
              "launches": {k: launches[k] for k in ("hll_ring_step", "hll_estimate")},
              "rounds": timings["n_rounds"], "centrality_max_rel_diff": cent_err}
    return {"record": record, "rows": rows, "launches": launches}


# the card's published peaks (NVIDIA H100 SXM data sheet, dense): HBM bytes/s,
# bf16 tensor-core FLOP/s, f32 (and integer) FLOP/s outside the tensor cores,
# TF32 tensor-core FLOP/s
PEAK_BYTES, PEAK_BF16, PEAK_F32 = 3.35e12, 989e12, 67e12
PEAK_TF32 = 495e12  # TF32 on the tensor cores (K16a's 3xTF32 products)


@contextlib.contextmanager
def counted_rounds(cls):
    """cls.run's return values (the AMPC coordinator's rounds) appended to
    the yielded list while the block runs."""
    real, rounds = cls.run, []

    def run(self, *a, **kw):
        rounds.append(real(self, *a, **kw))
        return rounds[-1]
    cls.run = run
    try:
        yield rounds
    finally:
        cls.run = real


def close_clients(*clients) -> None:
    """Close RemoteClients' pooled connections (a sonic server's stop waits
    on the open ones)."""
    for c in clients:
        c.close()


def graph_roles_phase(data_dir: str) -> dict:
    """The rest of the graph (main.py webgraph | webgraph-server | ampc):
    `webgraph create` over 2 seeded WARC files (page level), then `merge`;
    the two graphs served as webgraph shards, shard 1 by `main.py
    webgraph-server` as a process, shard 0 by entrypoint/webgraph_server.py
    run, both found by gossip: RemoteWebgraph answers every method as the
    merged graph does (links and labels as multisets, group sketches by
    their register bytes, exact groups as sets) and similar_hosts as the two
    local services merged. Then the AMPC harmonic job on bench_centrality's
    graph (ROLES_NODES, ROLES_EDGES, seed 0, precision 6): ROLES_DHT DHT shards and
    ROLES_SHARDS harmonic workers on DEVICE over gossip, the coordinator
    through entrypoint/ampc.py, counts reset just before and read just
    after: K6a launched rounds x shards times. The same job with CPU workers
    beside a worker of shard 0 stopped before the run: the same
    centralities, bit for bit; both within 1e-4 of `main.py centrality
    harmonic` on DEVICE. Shortest paths from one source over ROLES_SHARDS
    shortest-path workers equal webgraph/shortest_path.distances on DEVICE
    (K7); approx-harmonic over ROLES_SAMPLES sources equals
    approx_harmonic_centrality on DEVICE within rtol 1e-12; a 3-replica
    raft group takes writes before and after its leader is stopped. →
    {"record", "launches"}."""
    import numpy as np

    from stract_tpu_torch.ampc import harmonic as AH
    from stract_tpu_torch.ampc.coordinator import Coordinator
    from stract_tpu_torch.ampc.dht import DhtClient, start_dht
    from stract_tpu_torch.ampc.raft import start_raft_group
    from stract_tpu_torch.ampc.worker import start_worker
    from stract_tpu_torch.distributed.cluster import Cluster, Service
    from stract_tpu_torch.entrypoint import ampc as EA
    from stract_tpu_torch.entrypoint import bench_centrality as BC
    from stract_tpu_torch.entrypoint import webgraph_server as WS
    from stract_tpu_torch.main import main as port_main
    from stract_tpu_torch.main import run_centrality
    from stract_tpu_torch.ops import kernels
    from stract_tpu_torch.utils.hashing import prehash
    from stract_tpu_torch.warc_corpus import write_warcs
    from stract_tpu_torch.webgraph import Webgraph
    from stract_tpu_torch.webgraph.remote import RemoteWebgraph
    from stract_tpu_torch.webgraph.shortest_path import approx_harmonic_centrality, distances

    root = os.path.join(data_dir, "graph_roles")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    secs = {}

    def toml(name: str, text: str) -> str:
        path = os.path.join(root, name)
        with open(path, "w") as fh:
            fh.write(text)
        return path

    # ---- main.py webgraph create | merge --------------------------------------------
    t = time.perf_counter()
    info = write_warcs(os.path.join(root, "warc"), 2, ROLES_PAGES, seed=28, hosts=ROLES_HOSTS,
                       words=ROLES_WORDS)
    shards = [os.path.join(root, f"graph{i}") for i in range(2)]
    for w, out in zip(info.paths, shards):
        port_main(["webgraph", "create", toml(os.path.basename(out) + ".toml",
                  f'warc_paths = ["{w}"]\noutput_path = "{out}"\nlevel = "page"\n')])
    merged_dir = os.path.join(root, "merged")
    port_main(["webgraph", "merge", toml("merge.toml", f'warc_paths = {json.dumps(shards)}\n'
                                          f'output_path = "{merged_dir}"\n')])
    merged, parts = Webgraph(merged_dir), [Webgraph(p) for p in shards]
    if not 0 < max(g.num_edges for g in parts) < merged.num_edges:
        raise AssertionError(f"the merge lost edges: {[g.num_edges for g in parts]} -> "
                             f"{merged.num_edges}")
    secs["webgraph_create_merge"] = time.perf_counter() - t

    # ---- two webgraph shards over gossip, one of them a process ---------------------------
    t = time.perf_counter()
    seed = Cluster.join(Service("api"), interval=0.2)
    seeds = f'seeds = ["{seed.gossip_addr[0]}:{seed.gossip_addr[1]}"]\n'
    proc = subprocess.Popen([sys.executable, "-m", "stract_tpu_torch.main", "webgraph-server",
                             toml("wg1.toml", f'graph_path = "{shards[1]}"\nshard = 1\n'
                                  f'[gossip]\n{seeds}')], cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    local, local_cluster = WS.run(shards[0], 0, gossip_seeds=[seed.gossip_addr])
    remote = None
    try:
        deadline = time.monotonic() + 120
        while len({s.shard for s in seed.services("webgraph")}) < 2:
            if time.monotonic() > deadline or proc.poll() is not None:
                raise RuntimeError("the webgraph servers did not join gossip: "
                                   f"{proc.stdout.read()[-2000:] if proc.poll() is not None else ''}")
            time.sleep(0.1)
        remote = RemoteWebgraph.from_cluster(seed)
        services = [WS.WebGraphService(g, i) for i, g in enumerate(parts)]
        mine = WS.WebGraphService(merged)
        rng = np.random.default_rng(28)
        checked = 0
        big = 1 << 20
        for rank in rng.choice(merged.num_nodes, 48, replace=False).tolist():
            node = merged.name_of(rank)
            for method, body in (("backlinks", {"node": node, "limit": big}),
                                 ("forwardlinks", {"node": node, "limit": big})):
                got = getattr(remote, method)(node, big)
                want = getattr(mine, method)(body)
                if sorted(map(json.dumps, got)) != sorted(map(json.dumps, want)):
                    raise AssertionError(f"{method}({node}) differs from the merged graph's")
            if sorted(remote.backlink_labels(node, big)) != sorted(merged.backlink_labels(node,
                                                                                          big)):
                raise AssertionError(f"backlink_labels({node}) differs")
            for d in ("to", "from"):
                got = {h: s.to_bytes() for h, s in remote.group_sketch(node, d, 8).items()}
                want = {h: s.to_bytes() for h, s in merged.group_sketch(node, d, 8).items()}
                if got != want:
                    raise AssertionError(f"group_sketch({node}, {d}) differs")
                got = {h: set(v) for h, v in remote.group_exact(node, d, big).items()}
                if got != {h: set(v) for h, v in merged.group_exact(node, d, big).items()}:
                    raise AssertionError(f"group_exact({node}, {d}) differs")
            if not remote.knows(node) or remote.id2node(prehash(node)) != node:
                raise AssertionError(f"knows / id2node({node}) differ")
            sim = sorted([x for sv in services for x in sv.similar_hosts({"hosts": [node], "top_k": 5})],
                         key=lambda x: -x["score"])[:5]
            if remote.similar_hosts([node], 5) != sim:
                raise AssertionError(f"similar_hosts({node}) differs from the shards' merge")
            checked += 1
        if remote.knows("nothing.example") or remote.id2node(7) is not None:
            raise AssertionError("an unknown node was found")
    finally:
        proc.kill()
        proc.wait()
        if remote is not None:
            remote.client.close()
        local_cluster.shutdown()
        local.stop()
        seed.shutdown()
    secs["webgraph_servers"] = time.perf_counter() - t

    # ---- the AMPC harmonic job: workers on the card, then on the CPU ---------------------
    t = time.perf_counter()
    g = BC.write_bench_graph(os.path.join(root, "ampc-graph"), ROLES_NODES, ROLES_EDGES)
    secs["graph"] = time.perf_counter() - t
    t = time.perf_counter()
    seed = Cluster.join(Service("admin"), interval=0.2)
    dhts = [EA.run_dht(node_id=i, gossip_seeds=[seed.gossip_addr]) for i in range(ROLES_DHT)]
    workers = [EA.run_harmonic_worker(g.path, s, ROLES_SHARDS, 6, gossip_seeds=[seed.gossip_addr],
                                      device=DEVICE) for s in range(ROLES_SHARDS)]
    deadline = time.monotonic() + 60
    while len({x.shard for x in seed.services("ampc-dht")}) < ROLES_DHT:
        if time.monotonic() > deadline:
            raise RuntimeError("the DHT shards did not join gossip")
        time.sleep(0.1)
    secs["ampc_start"] = time.perf_counter() - t
    try:
        kernels.reset_launches()
        t = time.perf_counter()
        with counted_rounds(Coordinator) as rounds:
            cent = EA.run_harmonic_coordinator(g.path, os.path.join(root, "ampc-kv"),
                                               ROLES_SHARDS, 6, gossip_seeds=[seed.gossip_addr],
                                               wait_s=60.0)
        secs["ampc_harmonic"] = time.perf_counter() - t
        launches = dict(kernels.LAUNCHES)
    finally:
        for server, cl, *_ in dhts + workers:
            cl.shutdown()
            server.stop()
        seed.shutdown()
    n_rounds = rounds[0]
    if n_rounds < 2 or DEVICE == "cuda" and launches["hll_merge"] != n_rounds * ROLES_SHARDS:
        raise AssertionError(f"K6a: {launches['hll_merge']} launches in {n_rounds} rounds of "
                             f"{ROLES_SHARDS} shards")
    t = time.perf_counter()
    parts_e = AH.partition_edges(g, ROLES_SHARDS)
    dead = start_worker(AH.HarmonicWorker(0, ROLES_SHARDS, *parts_e[0], g.num_nodes, 6,
                                          device="cpu"))
    dead_addr = dead.addr
    dead.stop()
    cpu = [start_worker(AH.HarmonicWorker(s, ROLES_SHARDS, ef, et, g.num_nodes, 6, device="cpu"))
           for s, (ef, et) in enumerate(parts_e)]
    servers, client = start_dht(ROLES_DHT)
    try:
        with counted_rounds(Coordinator) as cpu_rounds:
            cent_cpu = AH.run_distributed_harmonic(g, [dead_addr] + [w.addr for w in cpu], client,
                                                   ROLES_SHARDS)
    finally:
        close_clients(*client.clients)
        for x in servers + cpu:
            x.stop()
    secs["ampc_harmonic_cpu"] = time.perf_counter() - t
    if cpu_rounds != rounds or list(cent_cpu.items()) != list(cent.items()):
        raise AssertionError(f"the card's workers and the CPU's differ: rounds {rounds} "
                             f"{cpu_rounds}")
    t = time.perf_counter()
    cfg = toml("harmonic.toml", f'webgraph_path = "{g.path}"\noutput_path = '
               f'"{root}/harmonic-kv"\nprecision = 6\n')
    single = run_centrality("harmonic", cfg, DEVICE)
    secs["single_device_harmonic"] = time.perf_counter() - t
    harmonic_diff = max(abs(cent[k] - v) for k, v in single.items())
    if set(single) != set(cent) or not harmonic_diff < 1e-4:
        raise AssertionError(f"the AMPC job and the single-device job differ by {harmonic_diff}")

    # ---- shortest paths and approx-harmonic over shortest-path workers -------------------
    t = time.perf_counter()
    seed = Cluster.join(Service("admin"), interval=0.2)
    dhts = [EA.run_dht(node_id=i, gossip_seeds=[seed.gossip_addr]) for i in range(ROLES_DHT)]
    workers = [EA.run_shortest_path_worker(g.path, s, ROLES_SHARDS,
                                           gossip_seeds=[seed.gossip_addr])
               for s in range(ROLES_SHARDS)]
    source = g.name_of(int(np.argmax([cent[g.name_of(i)] for i in range(g.num_nodes)])))
    try:
        launches_sp = kernels.LAUNCHES["bfs_relax"]
        dist = EA.run_shortest_path_coordinator(g.path, source, "", ROLES_SHARDS,
                                                gossip_seeds=[seed.gossip_addr], wait_s=60.0)
        secs["ampc_shortest_path"] = time.perf_counter() - t
        t = time.perf_counter()
        approx = EA.run_approx_harmonic_coordinator(g.path, "", ROLES_SHARDS, ROLES_SAMPLES, 0,
                                                    gossip_seeds=[seed.gossip_addr], wait_s=60.0)
        secs["ampc_approx_harmonic"] = time.perf_counter() - t
    finally:
        for server, cl, *_ in dhts + workers:
            cl.shutdown()
            server.stop()
        seed.shutdown()
    t = time.perf_counter()
    bfs = distances(g, source, device=DEVICE)
    approx_dev = approx_harmonic_centrality(g, ROLES_SAMPLES, seed=0, device=DEVICE)
    secs["device_bfs"] = time.perf_counter() - t
    if DEVICE == "cuda" and kernels.LAUNCHES["bfs_relax"] == launches_sp:
        raise AssertionError("distances() did not launch K7")
    if dist != bfs or len(dist) < 2:
        raise AssertionError(f"AMPC distances ({len(dist)} nodes) differ from the BFS's "
                             f"({len(bfs)})")
    np.testing.assert_allclose([approx[k] for k in approx_dev], list(approx_dev.values()),
                               rtol=1e-12, atol=0)

    # ---- a raft group: the leader stopped, writes continue -----------------------------
    t = time.perf_counter()
    nodes_r, servers_r, rclient = start_raft_group(3)
    try:
        def leader_of(group):
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                leaders = [x for x in group if x.state == "leader"]
                if len(leaders) == 1:
                    return leaders[0]
                time.sleep(0.05)
            raise AssertionError("no single raft leader")

        old = leader_of(nodes_r)
        for i in range(20):
            rclient.write("batch_upsert", {"table": "c", "fn": "u64_add", "pairs": [(b"n", 1)]})
        idx = nodes_r.index(old)
        old.stop()
        close_clients(rclient.clients[idx], *old.peers.values(),
                      *[x.peers[old.id] for x in nodes_r if x is not old])
        servers_r[idx].stop()
        new = leader_of([x for x in nodes_r if x is not old])
        for i in range(20):
            rclient.write("batch_upsert", {"table": "c", "fn": "u64_add", "pairs": [(b"n", 1)]})
        got = rclient.read("batch_get", {"table": "c", "keys": [b"n"]})
        if got != [40] or new is old:
            raise AssertionError(f"the raft group read {got} after its failover")
    finally:
        for x in nodes_r:
            x.stop()
        close_clients(*rclient.clients, *[c for x in nodes_r for c in x.peers.values()])
        for x in servers_r:
            x.stop()
    secs["raft"] = time.perf_counter() - t
    rec = {"nodes": g.num_nodes, "edges": g.num_edges, "cut": f"from {GRAPH_NODES:,} nodes",
           "webgraph": {"pages": info.pages, "merged_nodes": merged.num_nodes,
                        "merged_edges": merged.num_edges, "nodes_checked": checked},
           "rounds": n_rounds, "worker_shards": ROLES_SHARDS, "dht_shards": ROLES_DHT,
           "k6a_launches": launches["hll_merge"], "harmonic_max_diff_vs_single": harmonic_diff,
           "reached": len(dist), "approx_samples": ROLES_SAMPLES,
           "seconds": {k: round(v, 3) for k, v in secs.items()}}
    return {"record": rec, "launches": launches}


def bound(nbytes: float, ops: float, peak: float = PEAK_F32) -> tuple:
    """The least time the card could take: bytes moved once over the memory
    rate, or the operations over their peak, whichever is larger → (ms, "bytes"
    or "operations")."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / peak
    return (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def library_phase() -> dict:
    """The time of one PyTorch call that computes the function of a kernel,
    where one exists, at the kernel's main shape (used nowhere in the port):
    K5a scaled_dot_product_attention with the additive mask, K14a its
    backward through autograd, K5b layer_norm of the sum widened to f32 with
    the f32 weight and bias, cast to bf16 (PyTorch's CUDA layer_norm refuses
    a bf16 input with an f32 weight; the call with both in bf16, which
    rounds the affine, is logged beside it), K5c the tanh GELU over the sum, K14b native_layer_norm_backward through autograd, K14c
    aten.gelu_backward (tanh) of the sum and the column sum, K14d
    torch._fused_adamw_ (what AdamW(fused=True) calls). → {kernel: ms}."""
    import torch
    import torch.nn.functional as F

    g = torch.Generator().manual_seed(SEED + 7)
    bf = lambda *shape: torch.randn(shape, generator=g).to(DEVICE, torch.bfloat16)  # noqa: E731
    out = {}

    def sdpa(B, T):
        q, k, v = (bf(B, 12, T, 32) for _ in range(3))
        mask = torch.zeros((B, 1, 1, T), dtype=torch.bfloat16, device=DEVICE)
        mask[1, ..., T // 2:] = torch.finfo(torch.float32).min
        return q, k, v, mask
    q, k, v, mask = sdpa(ENC_B, ENC_T)
    out["attention"] = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask))
    q, k, v, mask = sdpa(TRAIN_B, TRAIN_T)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    o = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    do = torch.randn(o.shape, generator=g).to(DEVICE, torch.bfloat16)
    out["attention_backward"] = time_ms(
        lambda: torch.autograd.grad(o, (q, k, v), do, retain_graph=True))
    m = ENC_B * ENC_T
    x, r = bf(m, 384), bf(m, 384)
    w, b = torch.ones(384, device=DEVICE), torch.zeros(384, device=DEVICE)
    out["add_layernorm"] = time_ms(layernorm_library(x, r, w, b))
    log(f"[library] K5b's library call with a bf16 weight and bias: "
        f"{time_ms(lambda: F.layer_norm(x + r, (384,), w.to(x.dtype), b.to(x.dtype), 1e-12)):.4f}"
        " ms")
    y, yb = bf(m, 1536), bf(1536)
    out["bias_gelu"] = time_ms(lambda: F.gelu(y + yb, approximate="tanh"))
    m = TRAIN_B * TRAIN_T  # the backward kernels' shapes
    x, r, dy = bf(m, 384), bf(m, 384), bf(m, 384)
    out["add_layernorm_backward"] = time_ms(layernorm_backward_library(x, r, w, dy))
    y, yb, gout = bf(m, 1536), bf(1536), bf(m, 1536)
    out["bias_gelu_backward"] = time_ms(bias_gelu_backward_library(y, yb, gout))
    n = 22_565_376
    p, gr, mo, ve = (torch.randn(n, generator=g).to(DEVICE) for _ in range(4))
    ve.abs_()
    steps = torch.ones((), device=DEVICE)
    out["adamw"] = time_ms(lambda: torch._fused_adamw_(
        [p], [gr], [mo], [ve], [], [steps], lr=3e-4, beta1=0.9, beta2=0.999,
        weight_decay=1e-4, eps=1e-8, amsgrad=False, maximize=False))
    return out


def kernel_records(rows, rows_m, cent, library, serve_launches, train_launches, forest,
                   card, config_launches, moe_launches, mesh, pipe, grid, te_launches) -> list:
    """Every kernel's entry of the `kernels` line: its largest error against
    the plain version; its time, the plain version's, the bound and the
    library call's at the main shape; its launches in the run of its own
    path, named under "path" (training for the training kernels and the pool,
    the centrality jobs for the graph kernels, its configuration's HTTP round
    for the configurations' kernels, one direct call for the DIRECT three,
    the MoE steps for K15a-d, K15c's heads summed over the training, the MoE
    steps and train-encoders (`te_launches`), the mesh's serving round for K9 and its
    HyperBall for K8, the pipelined train steps for K16a-d, the pipeline-on
    traffic for the rest; `grid`: the attention grid's rows, each with its
    own bound). Each measured row is logged too."""
    all_rows = [(name, err, ms, pms, shape, *bound(nb, ops), ds)
                for name, ds, err, ms, pms, shape, nb, ops in rows]
    all_rows += [(name, err, ms, pms, shape, *bound(*work(name, shape, forest)), True)
                 for name, err, ms, pms, shape in rows_m]
    all_rows += [(name, err, ms, pms, shape, *bound(nb, ops, *peak), True)
                 for name, err, ms, pms, shape, nb, ops, *peak in
                 cent["rows"] + mesh["rows"] + pipe["rows"] + grid]
    for name, err, ms, pms, shape, bms, by, ds in all_rows:
        log(f"[kernel] {name:13s} default_static={ds!s:5s} shape={shape} max_abs_err={err:.3g} "
            f"tolerance=({TOL_TEXT[name]}) kernel={ms:.3f} ms plain={pms:.3f} ms "
            f"bound={bms:.4f} ms ({by}) library={library.get(name)} card={card}")

    src = "stract_tpu_torch/csrc/"
    step = "stract_tpu/entrypoint/train_encoders.py:244"
    meta = {"stage_a": ("cuda", src + "scoring.cu", "stract_tpu/ops/scoring.py:807", None),
            "stage_b": ("cuda", src + "scoring.cu", "stract_tpu/ops/scoring.py:660", KD),
            "signals_q16": ("cuda", src + "scoring.cu", "stract_tpu/ops/scoring.py:886", 512),
            "stage_a_q8": ("cuda", src + "scoring.cu", "stract_tpu/ops/scoring.py:162", None),
            "stage_a_ub": ("cuda", src + "scoring.cu", "stract_tpu/ops/scoring.py:837",
                           (C, "12B rows")),
            "factors_join": ("cuda", src + "scoring.cu", "stract_tpu/ops/scoring.py:749", KD),
            "stage_b_joined": ("cuda", src + "scoring.cu", "stract_tpu/ops/scoring.py:770", KD),
            "signals_joined": ("cuda", src + "scoring.cu", "stract_tpu/ops/scoring.py:894", 512),
            "signals_prefix": ("cuda", src + "scoring.cu", "stract_tpu/ops/scoring.py:859", 512),
            "dense_rerank": ("cuda", src + "scoring.cu", "stract_tpu/ops/dense_rerank.py:31",
                             RERANK_K),
            "forest": ("cuda", src + "forest.cu",
                       "stract_tpu/ranking/models/lambdamart.py:195", FOREST_K[-1]),
            "attention": ("cuda", src + "encoder.cu", "stract_tpu/models/bert.py:97", ENC_T),
            "add_layernorm": ("cuda", src + "encoder.cu", "stract_tpu/models/bert.py:164",
                              ENC_B * ENC_T),
            "bias_gelu": ("cuda", src + "encoder.cu", "stract_tpu/models/bert.py:170",
                          ENC_B * ENC_T),
            "mean_pool": ("cuda", src + "encoder.cu", "stract_tpu/models/bert.py:222",
                          TRAIN_B * TRAIN_T),
            "attention_backward": ("cuda", src + "encoder.cu", step, TRAIN_T),
            "add_layernorm_backward": ("cuda", src + "encoder.cu", step, TRAIN_B * TRAIN_T),
            "bias_gelu_backward": ("cuda", src + "encoder.cu", step, TRAIN_B * TRAIN_T),
            "adamw": ("triton", "stract_tpu_torch/optim.py", step, None),
            "hll_merge": ("cuda", src + "graph.cu", "stract_tpu/ops/hll_ops.py:50", None),
            "hll_estimate": ("cuda", src + "graph.cu", "stract_tpu/ops/hll_ops.py:64", None),
            "bfs_relax": ("cuda", src + "graph.cu", "stract_tpu/webgraph/shortest_path.py:21",
                          (GRAPH_NODES, GRAPH_SAMPLES)),
            "stage_a_merge": ("cuda", src + "scoring.cu", "stract_tpu/ops/scoring.py:286",
                              (MERGE_P, L, C)),
            "moe_router": ("cuda", src + "moe.cu", "stract_tpu/models/bert.py:124", None),
            "moe_select": ("cuda", src + "moe.cu", "stract_tpu/models/bert.py:151", None),
            "pair_loss": ("cuda", src + "losses.cu", "stract_tpu/parallel/train.py:26",
                          (MOE_B, "distilled")),
            "info_nce": ("cuda", src + "losses.cu",
                         "stract_tpu/entrypoint/train_encoders.py:249", TRAIN_B),
            "adamw_bf16": ("triton", "stract_tpu_torch/optim.py",
                           "stract_tpu/parallel/train.py:36", None),
            "mesh_topk": ("cuda", src + "scoring.cu", "stract_tpu/parallel/search.py:81",
                          MESH_TOPK_SHAPES[0]),
            "hll_ring_step": ("cuda", src + "graph.cu",
                              "stract_tpu/webgraph/centrality.py:153", None),
            "stage_attention": ("cuda", src + "stage.cu", "stract_tpu/parallel/pipeline.py:46",
                                None),
            "stage_attention_backward": ("cuda", src + "stage.cu",
                                         "stract_tpu/parallel/pipeline.py:133", None),
            "gelu_tanh": ("cuda", src + "stage.cu", "stract_tpu/parallel/pipeline.py:50",
                          None),
            "sgd": ("cuda", src + "stage.cu", "stract_tpu/parallel/pipeline.py:136", None)}
    out = []
    for name, (route, source, replaces, main_shape) in meta.items():
        mine = [r for r in all_rows if r[0] == name]
        main_row = next(r for r in mine if r[7] and main_shape in (
            None, r[4], r[4][:2] if isinstance(r[4], tuple) else None))
        if name in LOSS_HEADS:
            launches = (train_launches[name] + moe_launches[name]
                        + te_launches.get(name, 0))
            path = ("training: the dual encoder's steps, main.py train-encoders"
                    if name == "info_nce" else "training: the cross encoder's distilled steps, "
                    "the MoE steps, main.py train-encoders")
        elif name in DIRECT:
            launches, path = config_launches[name], "direct call: no entry point reaches it"
        elif name in MOE_KERNELS[:4]:
            launches, path = moe_launches[name], "training: the MoE cross encoder's steps"
        elif name in config_launches:
            launches, path = config_launches[name], "http, pipeline off, its configuration"
        elif name in TRAINING[3:]:
            launches, path = train_launches[name], "training"
        elif name in mesh["launches"]:
            launches, path = mesh["launches"][name], mesh["paths"][name]
        elif name in pipe["launches"]:
            launches = pipe["launches"][name]
            path = (f"training: {PIPE_STEPS} pipelined SGD steps on a (pp={PIPE_S}, "
                    f"dp={PIPE_DP}) mesh")
        elif name == "bfs_relax":
            launches = cent["jobs"]["approx-harmonic"]["launches"][name]
            path = "centrality approx-harmonic"
        elif name.startswith("hll"):
            launches, path = cent["jobs"]["harmonic"]["launches"][name], "centrality harmonic"
        else:
            launches, path = serve_launches[name], "http, pipeline on"
        out.append({"name": name, "route": route, "source": source, "replaces": replaces,
                    "launches": launches, "path": path, "max_abs_err": max(r[1] for r in mine),
                    "ms": main_row[2], "plain_ms": main_row[3], "bound_ms": main_row[5],
                    "bound_by": main_row[6], "library_ms": library.get(name)})
    return out


def work(name: str, shape, forest=None) -> tuple:
    """(bytes, operations, peak) of one call of a kernel of the ranking
    pipeline or the training step at its main-path shape: each input read
    once, each output written once; bf16 products at the tensor-core peak."""
    H, F_ = 384, 1536
    if name == "forest":  # K = shape rows of 46 features; the forest's arrays once
        T, N = forest.feature.shape
        return 4 * shape * 47 + 16 * T * N + 4 * forest.leaf_value.numel(), \
            2 * shape * T * forest.max_depth, PEAK_F32
    if name == "attention":  # B=ENC_B, T=shape, 12 heads x 32
        return 4 * ENC_B * shape * H * 2 + 4 * ENC_B * shape, \
            4 * ENC_B * 12 * shape * shape * 32, PEAK_BF16
    if name == "attention_backward":  # B=TRAIN_B, T=shape; S, dP, dV, dK, dQ: 5 T^2 d FMAs a head
        return 7 * TRAIN_B * shape * H * 2 + 4 * TRAIN_B * shape, \
            10 * TRAIN_B * 12 * shape * shape * 32, PEAK_BF16
    if name == "add_layernorm":
        return 3 * shape * H * 2 + 8 * H, 8 * shape * H, PEAK_F32
    if name == "add_layernorm_backward":  # shape: rows, or (rows, N) off MiniLM's width
        M, N = shape if isinstance(shape, tuple) else (shape, H)
        return 4 * M * N * 2 + 12 * N, 12 * M * N, PEAK_F32
    if name == "bias_gelu":
        return 2 * shape * F_ * 2 + 2 * F_, 20 * shape * F_, PEAK_F32
    if name == "bias_gelu_backward":  # shape: rows, or (rows, N) off MiniLM's FFN width
        M, N = shape if isinstance(shape, tuple) else (shape, F_)
        return 3 * M * N * 2 + 4 * N, 40 * M * N, PEAK_F32
    if name == "mean_pool":  # forward + backward over TRAIN_B rows of TRAIN_T tokens: the
        # forward reads the kept tokens' rows (the smoke's mask drops row 1's second half
        # and row 2), the backward writes every row
        kept = shape - TRAIN_T // 2 - TRAIN_T
        return (kept + shape) * H * 2 + 8 * shape + 4 * TRAIN_B * H * 4, 4 * shape * H, \
            PEAK_F32
    if name == "adamw":  # p, g, m, v in; p, m, v out
        return 28 * shape, 15 * shape, PEAK_F32
    raise KeyError(name)


def in_phase(name: str, fn, *args, **kw):
    """fn(*args, **kw) as the phase `name`: if it raises, print `[name]
    FAILED: <type>: <message>` to stderr, flush, and re-raise, so a failed
    run names the phase it failed in and still exits non-zero."""
    try:
        return fn(*args, **kw)
    except BaseException as exc:
        print(f"[{name}] FAILED: {type(exc).__name__}: {exc}", file=sys.stderr, flush=True)
        raise


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from stract_tpu_torch import native
    from stract_tpu_torch.ops import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card: {card}")

    def build():
        kernels.build(verbose=True)
        if not native.available():  # else the host factor join drops to Python
            raise RuntimeError("the native host library (native/) did not build or load")

    t_start = t = time.perf_counter()
    in_phase("build", build)
    log(f"[setup] kernels and the native host library built in {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    data_dir = os.path.join(ROOT, "data", "torch_smoke")
    mesh_proc = in_phase("mesh corpus", start_mesh_corpus, data_dir)
    try:
        return run_phases(data_dir, mesh_proc, card, t_start, t)
    finally:
        if mesh_proc.poll() is None:
            mesh_proc.kill()
            mesh_proc.wait()


def run_phases(data_dir: str, mesh_proc, card: str, t_start: float, t: float) -> int:
    import torch

    from stract_tpu_torch import bench_corpus as bc
    from stract_tpu_torch.index.embeddings import write_embedding_columns
    from stract_tpu_torch.main import build_searcher
    from stract_tpu_torch.models.dual_encoder import DualEncoder
    from stract_tpu_torch.ranking.models.lambdamart import LambdaMART

    index_dir = in_phase("corpus", bc.ensure_corpus, data_dir, DOCS, seed=SEED, log=log)
    log(f"[setup] corpus ready in {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    searcher = in_phase("index", build_searcher, index_dir, DEVICE)
    index = searcher.searcher.searchers[0].index
    torch.cuda.synchronize()
    log(f"[setup] index on the card in {time.perf_counter() - t:.1f}s; "
        f"{torch.cuda.memory_allocated() / 2**20:.0f} MiB held")

    # ---- pipeline off: K1-K3 --------------------------------------------------------
    rows = in_phase("kernels", kernel_phase, index, DEVICE)
    torch.cuda.reset_peak_memory_stats()
    with join_timer() as join_off:
        served_off = in_phase("serve off", serve_phase, searcher, SCORING)
    log(f"[serve off] {json.dumps(served_off)}")
    log(f"[serve off] host factor join: {join_off['calls']} calls, {join_off['seconds']:.3f} s "
        f"of the round's {served_off['wall_s']:.3f} s")
    default_pages = in_phase("compare off", top10_pages, searcher)
    cmp = in_phase("compare off", compare_phase, searcher)
    log(f"[compare off] top-10 kernels vs plain versions: {json.dumps(cmp)}")
    in_phase("optics", optic_phase, searcher, "default", SCORING, card)
    in_phase("linear", linear_phase, index, card)
    in_phase("side answers", side_phase, searcher, card)
    t = time.perf_counter()
    page = in_phase("page", page_phase, searcher, index, data_dir, card)
    log(f"[result page] entities={page['entities']} images={page['images']} zim_s="
        f"{page['zim_s']:.1f} index_s={page['index_s']:.1f} graph_s={page['graph_s']:.1f} "
        f"page_graph={page['page_nodes']}x{page['page_edges']} host_graph={page['host_nodes']} "
        f"sidebar_hits={page['sidebar_hits']} hit_p50_ms={page['sidebar_hit_p50_ms']:.1f} "
        f"hit_p99_ms={page['sidebar_hit_p99_ms']:.1f} sidebar_misses={page['sidebar_misses']} "
        f"miss_p50_ms={page['sidebar_miss_p50_ms']:.1f} miss_p99_ms="
        f"{page['sidebar_miss_p99_ms']:.1f} sidebar_parts_p50_p99_max_ms="
        f"{json.dumps(page['sidebar_parts_ms'])} route_p50_ms={json.dumps(page['route_p50_ms'])} "
        f"mixed_qps={page['mixed_qps']:.2f} ({page['mixed_requests']} requests) plain_mix_qps="
        f"{page['plain_qps']:.2f} ({page['plain_requests']}) links_past_the_cap="
        f"{page['links_past_the_cap']} search_websites_max_score_diff="
        f"{page['search_websites_max_score_diff']:.3g} search_websites_launches="
        f"{json.dumps(page['search_websites_launches'])} launches={json.dumps(page['launches'])} "
        f"seconds={time.perf_counter() - t:.1f} card={card}")
    log(f"[result off] docs={DOCS} qps={served_off['qps']:.2f} "
        f"p50_ms={served_off['p50_ms']:.1f} p99_ms={served_off['p99_ms']:.1f} "
        f"device_mem_peak_MiB={torch.cuda.max_memory_allocated() / 2**20:.0f} card={card}")

    # ---- training, then pipeline on: models, embedding columns, K4 + K5a-d, K14a-d ---
    models = in_phase("models", models_phase, searcher, index_dir,
                      os.path.join(data_dir, "models"))
    dual = in_phase("embeddings", DualEncoder.load, models["dual"], device=DEVICE)
    emb = in_phase("embeddings", write_embedding_columns, index_dir, dual, batch=EMB_BATCH,
                   log=log)
    torch.cuda.synchronize()
    log(f"[embeddings] {emb['docs']} docs x {emb['dim']} in {emb['seconds']:.1f}s: "
        f"{emb['docs'] / emb['seconds']:.0f} docs/s card={card}")
    tok = dual.tokenizer
    del dual
    built = in_phase("index build", index_phase, data_dir, models["dual"], card)
    log(index_line(built, card))
    live = in_phase("live", live_phase, data_dir, card)
    log(live_line(live, card))
    forest = in_phase("model kernels", LambdaMART.load, models["forest"], device=DEVICE)
    rows_m = (in_phase("model kernels", model_kernel_phase, forest, models["rows"])
              + in_phase("training kernels", training_kernel_phase, models["dual"]))
    grid = in_phase("attention grid", attention_grid_phase)
    library = in_phase("library", library_phase)
    step_ms = in_phase("train step", train_step_timing, tok)
    log(f"[train step] dual InfoNCE step B={TRAIN_B} T={TRAIN_T}: kernels "
        f"{step_ms['kernels']:.2f} ms, plain versions {step_ms['plain']:.2f} ms card={card}")
    te = in_phase("train-encoders", train_encoders_phase, index_dir,
                  os.path.join(data_dir, "train_encoders"))
    log(f"[result train-encoders] main.py train-encoders both INDEX OUT --steps 2 (tiny, head "
        f"dim 16): losses {te['losses']} launches {json.dumps(te['launches'])} seconds="
        f"{te['seconds']:.1f} card={card}")
    base = in_phase("bert-base", bert_base_phase, index_dir,
                    os.path.join(data_dir, "bert_base_dual"), tok)
    log(f"[result bert-base] {json.dumps(base)} card={card}")
    t = time.perf_counter()
    lgbm = in_phase("lightgbm", lgbm_forest_phase, os.path.join(data_dir, "lightgbm"))
    longer = in_phase("long", long_encoder_phase, index_dir,
                      os.path.join(data_dir, "long_dual"), tok)
    log(f"[result long] {json.dumps(longer['record'])} card={card}")
    grid += lgbm["rows"] + longer["rows"]
    t_added = time.perf_counter() - t
    del searcher
    torch.cuda.empty_cache()
    on = in_phase("serve on", build_searcher, index_dir, DEVICE, dual_encoder=models["dual"],
                  cross_encoder=models["cross"], lambdamart=models["forest"])
    torch.cuda.reset_peak_memory_stats()
    served = in_phase("serve on", serve_phase, on, SERVING, rounds=SERVE_ON_ROUNDS)
    log(f"[serve on] {json.dumps(served)}")
    cmp_on = in_phase("compare on", compare_phase, on, forest=on.pipeline.recall.lambdamart)
    log(f"[compare on] top-10 kernels vs plain versions: {json.dumps(cmp_on)}")
    log(f"[result on] docs={DOCS} rounds={served['rounds']} qps={served['qps']:.2f} "
        f"p50_ms={served['p50_ms']:.1f} p99_ms={served['p99_ms']:.1f} device_mem_peak_MiB="
        f"{torch.cuda.max_memory_allocated() / 2**20:.0f} device_mem_held_MiB="
        f"{torch.cuda.memory_allocated() / 2**20:.0f} embed_docs_per_s="
        f"{emb['docs'] / emb['seconds']:.0f} card={card}")
    del on
    torch.cuda.empty_cache()
    t = time.perf_counter()
    served_lgbm = in_phase("lightgbm serve", lgbm_serve_phase, index_dir, models,
                           lgbm["paths"][0])
    t_added += time.perf_counter() - t
    log(f"[result lightgbm serve] --lambdamart {os.path.basename(lgbm['paths'][0])} "
        f"({LGBM_FORESTS[0][0]} trees x {LGBM_FORESTS[0][1]} leaves) qps={served_lgbm['qps']:.2f} "
        f"p50_ms={served_lgbm['p50_ms']:.1f} p99_ms={served_lgbm['p99_ms']:.1f} failed="
        f"{served_lgbm['failed']} forest_launches={served_lgbm['launches']['forest']} "
        f"seconds_of_the_added_phases={t_added:.1f} card={card}")

    # ---- the other configurations: q8 rows, device join, UB; K11, K12, K10 ------------
    t = time.perf_counter()
    configs = in_phase("configs", config_phase, index_dir, default_pages, card)
    for name, rec in configs.items():
        log(f"[result config {name}] qps={rec['qps']:.2f} (default {served_off['qps']:.2f}) "
            f"p50_ms={rec['p50_ms']:.1f} p99_ms={rec['p99_ms']:.1f} failed={rec['failed']} "
            f"postings_MB={rec['postings_bytes'] / 1e6:.0f} host_join_s={rec['host_join_s']:.3f} "
            f"(default {join_off['seconds']:.3f}) top10_equal_default="
            f"{rec['top10_equal_default']}/{rec['compared']} card={card}")
    t_cfg = time.perf_counter() - t
    t = time.perf_counter()
    rows_c, ops_launches, lib_c = in_phase("config kernels", config_kernel_phase, index_dir,
                                           models["dual"])
    torch.cuda.empty_cache()
    config_launches = {"stage_a_q8": configs["q8"]["launches"]["stage_a_q8"],
                       "stage_a_ub": configs["ub"]["launches"]["stage_a_ub"],
                       "stage_b_joined": configs["join"]["launches"]["stage_b_joined"],
                       "signals_joined": configs["join"]["launches"]["signals_joined"],
                       "stage_a_merge": configs["merge"]["launches"]["stage_a_merge"],
                       **ops_launches}
    log(f"[configs] {len(CONFIGS)} configurations served in {t_cfg:.1f}s, their kernels held "
        f"against the plain versions in {time.perf_counter() - t:.1f}s")

    # ---- the MoE training path: K15a-d ------------------------------------------------
    moe = in_phase("moe", moe_phase, index_dir, models["dual"], card)
    torch.cuda.empty_cache()
    rec = moe["record"]
    log(f"[result moe] experts={MOE_E} steps={MOE_STEPS} pairs={MOE_B} tokens={TRAIN_T} "
        f"loss_first5={rec['loss_first5']:.4f} loss_last5={rec['loss_last5']:.4f} "
        f"curve_max_rel_diff_vs_plain={rec['curve_max_rel_diff']:.3g} step_ms_kernels="
        f"{rec['step_ms_kernels']:.2f} step_ms_plain={rec['step_ms_plain']:.2f} "
        f"seconds={rec['seconds']:.1f} card={card}")
    library.update(lib_c)
    library.update(moe["library"])

    # ---- the pipeline-parallel train step: K16a-d ----------------------------------
    pipe = in_phase("pipeline", pipeline_phase, card)
    torch.cuda.empty_cache()
    rec = pipe["record"]
    log(f"[result pipeline] stages={PIPE_S} hidden={PIPE_H} ffn={PIPE_F} tokens={PIPE_T} "
        f"mesh=(pp={PIPE_S}, dp={PIPE_DP}) microbatches={PIPE_M}x{PIPE_MB} steps={PIPE_STEPS} "
        f"loss_first={rec['loss_kernels'][0]:.4f} loss_last={rec['loss_kernels'][-1]:.4f} "
        f"curve_max_rel_diff_vs_plain={rec['curve_max_rel_diff']:.3g} forward_max_abs_err="
        f"{rec['forward_max_abs_err']:.3g} step_ms_kernels={rec['step_ms_kernels']:.2f} "
        f"step_ms_plain={rec['step_ms_plain']:.2f} seconds={rec['seconds']:.1f} card={card}")
    library.update(pipe["library"])

    # ---- the mesh of shards on the card: the shard server and coordinator, K9 -----------
    t = time.perf_counter()
    mesh_dir = in_phase("mesh corpus", mesh_corpus, mesh_proc)
    log(f"[mesh] corpus of {MESH_SHARDS} x {MESH_DOCS} docs ready {time.perf_counter() - t:.1f}s "
        f"after it was awaited: {mesh_dir}")
    mesh_serve = in_phase("mesh serve", mesh_serve_phase, mesh_dir, card)
    log(f"[result mesh serve] docs={mesh_serve['docs']} shards={MESH_SHARDS} qps="
        f"{mesh_serve['qps']:.2f} p50_ms={mesh_serve['p50_ms']:.1f} p99_ms="
        f"{mesh_serve['p99_ms']:.1f} failed={mesh_serve['failed']} mesh_topk_launches="
        f"{mesh_serve['launches']['mesh_topk']} driver_share={mesh_serve['driver_share']:.3f} "
        f"unsharded_qps={mesh_serve['unsharded_qps']:.2f} unsharded_p50_ms="
        f"{mesh_serve['unsharded_p50_ms']:.1f} unsharded_p99_ms="
        f"{mesh_serve['unsharded_p99_ms']:.1f} pass1_max_score_diff="
        f"{mesh_serve['pass1_max_score_diff']:.3g} page_max_score_diff="
        f"{mesh_serve['page_max_score_diff']:.3g} card={card}")
    rows_k9, library["mesh_topk"] = in_phase("mesh topk", mesh_topk_rows)

    # ---- the webgraph centrality job: K6a-b, K7 --------------------------------------
    cent = in_phase("centrality", centrality_phase, os.path.join(data_dir, "centrality"))
    log(f"[result centrality] nodes={GRAPH_NODES} edges={GRAPH_EDGES} graph_s="
        f"{cent['graph_s']:.1f} harmonic_s={cent['jobs']['harmonic']['seconds']:.2f} "
        f"hyperball_rounds={cent['jobs']['harmonic']['timings']['n_rounds']} "
        f"approx_harmonic_s={cent['jobs']['approx-harmonic']['seconds']:.2f} "
        f"bfs_rounds={cent['jobs']['approx-harmonic']['timings']['n_rounds']} "
        f"total_s={time.perf_counter() - t_start:.1f} card={card}")

    # ---- the webgraph centrality job on a mesh of shards: K8 -------------------------
    mesh_cent = in_phase("mesh centrality", mesh_centrality_phase,
                         os.path.join(data_dir, "centrality"), cent, card)
    log(f"[result mesh centrality] {json.dumps(mesh_cent['record'])} card={card}")

    # ---- the rest of the graph: webgraph servers, the AMPC roles (K6a), raft -----------
    t = time.perf_counter()
    roles = in_phase("graph roles", graph_roles_phase, data_dir)
    log(f"[result graph roles] {json.dumps(roles['record'])} seconds="
        f"{time.perf_counter() - t:.1f} card={card}")

    mesh = {"rows": rows_k9 + mesh_cent["rows"],
            "launches": {"mesh_topk": mesh_serve["launches"]["mesh_topk"],
                         "hll_ring_step": mesh_cent["launches"]["hll_ring_step"]},
            "paths": {"mesh_topk": f"http, a search shard on a mesh of {MESH_SHARDS} shards "
                                   "behind the coordinator",
                      "hll_ring_step": f"centrality harmonic on a mesh of {MESH_SHARDS} shards"}}
    kernels_out = in_phase("records", kernel_records, rows + rows_c + moe["rows"], rows_m, cent,
                           library, served["launches"], models["launches"], forest, card,
                           config_launches, moe["launches"], mesh, pipe, grid,
                           te["launches"])
    for rec in kernels_out:  # the index and live phases' launches beside the main path's
        if rec["name"] in INDEX_BUILD_KERNELS + SCORING:
            rec["index_launches"] = (built["build_launches"][rec["name"]]
                                     + built["serve_launches"][rec["name"]])
        if rec["name"] in SCORING:
            rec["live_launches"] = live["launches"][rec["name"]]
        if rec["name"] == "hll_merge":  # the AMPC harmonic workers' merges
            rec["ampc_launches"] = roles["launches"]["hll_merge"]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels_out}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
