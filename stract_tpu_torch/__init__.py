"""stract_tpu_torch — the search engine of stract_tpu on PyTorch and CUDA.

A port of the JAX package `stract_tpu`, which stays beside it as the
reference. The port imports torch and never jax, and nothing of the JAX
package: it keeps its own copies of the JAX package's jax-free host modules
(schema, tokenizer, snippets, signals, ranking pipeline, kv store, webgraph
store, the loader of the repository's native C++ host join), under the same
relative paths, and re-implements the modules that reach a device program.
Layout mirrors stract_tpu/:

  ops/scoring.py     stage A / stage B / pass-2 programs: plain PyTorch
                     versions and the dispatch to the CUDA kernels
  ops/forest.py      the LambdaMART forest walk (K4)
  ops/encoder.py     the BERT encoder's attention, residual + LayerNorm,
                     bias + GELU and mean pool (K5a-d), and the gradients of
                     the first three (K14a-c), as autograd Functions
  ops/hll_ops.py     HyperBall's register merge and size estimate (K6a-b)
  ops/kernels.py     nvcc build + ctypes binding of csrc/*.cu, launch counts
  optim.py           AdamW as optax.adamw, one fused update (K14d)
  models/            BERT (serving and f32-master training forms), dual
                     encoder, checkpoint store, WordPiece
  parallel/train.py  the encoders' train steps and losses (one card)
  entrypoint/        encoder training (triples, trainers, the bench tool),
                     the centrality jobs and their benchmark graph
  webgraph/          graph store, HyperBall harmonic centrality, BFS (K7)
  index/             segment reader, DeviceSegment, InvertedIndex (serving),
                     embedding-column writer
  ranking/, query/   slot planning, cross encoder, LambdaMART, query parser
                     and planner
  searcher/, api/    local shard, coordinator (the batched block path and the
                     object path), batcher, HTTP routes (search, the side
                     answers, links, entity images, improvement log, docs,
                     the UI of frontend/), user counts
  entity_index/,     the entity sidebar's host BM25 index, its ZIM reader and
  zim.py,            writer, its image store; entrypoint/entity.py builds it,
  image_store.py     entrypoint/entity_search_server.py serves it over RPC
  generic_query/,    the two-phase generic queries, the external-SERP scraper,
  leechy.py,         the optics language server (python -m
  optics_lsp.py      stract_tpu_torch.optics_lsp)
  optics/            the optics DSL; compile_groups lowers an optic into
                     constraint groups of the device plan
  spell/, widgets/,  spell correction and its trainer, the calculator and
  autosuggest.py     thesaurus widgets, query autosuggest
  bench_corpus.py    synthetic corpus writer and query generator
  main.py            `serve`, `train-encoders`, `centrality`, `search-server`,
                     `api`, `web-spell`, `indexer entity` and
                     `entity-search-server`
"""

__version__ = "0.1.0"
