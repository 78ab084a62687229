"""The port's optics and the shard's linear model against the JAX package's
on the CPU. One small index, built by the JAX package and opened by both,
takes the same requests through both packages:

- the cases of tests/test_optic_compile.py: DiscardNonMatching returns the
  3 matching documents that lie beyond the unfiltered top-K, a Discard rule
  and a wildcard site pattern remove documents from the candidates, blocked
  hosts compile into the excluded group, the value dictionaries survive a
  merge, content patterns and boosts stay in the residual;
- Optic.compile_groups (groups' pairs and patterns, the residual), parse
  errors, to_string round trips and Optic.apply on the same candidates;
- optic requests through the coordinator's flow (the residual in phase 2)
  and one through the port's HTTP route;
- a request's host rankings without an optic;
- the linear model's pages through LocalSearcher and through SearchService.

Filter outcomes are exactly equal (the same url sets). Scores agree within
rtol 1e-3 / atol 1e-3 (stage B's f32 sums in another order; with the linear
model, pass 2's q16 rows under its weights), ties compared as sets.
"""

from __future__ import annotations

import json
import urllib.request

import numpy as np
import pytest

from stract_tpu.index import InvertedIndex as JaxIndex
from stract_tpu.optics import optic as optic_jax
from stract_tpu.ranking.models.linear import LinearRegression as JaxLinear
from stract_tpu.searcher.local import LocalSearcher as JaxLocal
from stract_tpu.searcher.query import SearchQuery as JaxSQ
from stract_tpu_torch.index.inverted import InvertedIndex
from stract_tpu_torch.optics import optic as optic_port
from stract_tpu_torch.ranking.models.linear import LinearRegression
from stract_tpu_torch.searcher.local import LocalSearcher
from stract_tpu_torch.searcher.query import SearchQuery

from conftest import make_doc
from torch_parity import assert_topk_match

DNM_OPTIC = 'DiscardNonMatching;\nRule {\n    Matches {\n        Site("|target.site|")\n    }\n};\n'
DISCARD_OPTIC = 'Rule {\n    Matches {\n        Site("|target.site|")\n    },\n    Action(Discard)\n};\n'
WILDCARD_OPTIC = 'Rule {\n    Matches {\n        Site("|noise1*")\n    },\n    Action(Discard)\n};\n'
CONTENT_DNM = 'DiscardNonMatching;\nRule {\n    Matches {\n        Content("needle")\n    }\n};\n'
BOOST_OPTIC = 'Rule {\n    Matches {\n        Site("|a.com|")\n    },\n    Action(Boost(5))\n};\n'
LIKES_OPTIC = ('Like(Site("noise5.com")); Dislike(Site("noise6.com"));\n'
               'Rule { Matches { Site("|noise8.com|") }, Action(Boost(3)) };')

OPTICS = [
    DNM_OPTIC, DISCARD_OPTIC, WILDCARD_OPTIC, CONTENT_DNM, BOOST_OPTIC, LIKES_OPTIC,
    'Rule { Matches { Site("site1") }, Matches { Site("site2") }, Action(Discard) };',
    'Rule { Matches { Domain("|noise3.com|") }, Matches { Url("|https://noise4.com/page|") },'
    ' Action(Discard) };',
    'DiscardNonMatching; Rule { Matches { Site("|a.com|") }, Matches { Domain("|b.org|") } };'
    ' Rule { Matches { Title("guide") }, Action(Downrank(2)) };',
    'DiscardNonMatching; Rule { Matches { Site("|a.com|"), Title("x") } };',
    'Rule { Matches { Domain("noise*") }, Action(Downrank(1.5)) }; // trailing comment\n'
    '/* block */ Rule { Action(Discard) };',
]


@pytest.fixture(scope="module")
def big_dir(tmp_path_factory):
    """tests/test_optic_compile.py's index: 200 high-centrality 'noise' docs
    and 3 low-centrality docs on target.site, so the unfiltered top-50 never
    holds a target.site doc."""
    idx = JaxIndex(str(tmp_path_factory.mktemp("torch-optic")))
    for i in range(200):
        idx.insert(make_doc(f"https://noise{i}.com/page", f"widget catalog {i}",
                            "widget shopping catalog with many great widget deals",
                            host_centrality=0.9, host_centrality_rank=i + 1))
    for i in range(3):
        idx.insert(make_doc(f"https://target.site/p{i}", f"widget guide {i}",
                            "a widget guide from the target site",
                            host_centrality=0.001, host_centrality_rank=5000 + i))
    idx.commit()
    idx.merge_all()
    return idx.path


@pytest.fixture(scope="module")
def indexes(big_dir):
    return JaxIndex(big_dir), InvertedIndex(big_dir, "cpu")


def _found(index, cands) -> dict:
    return {index.retrieve([c.pointer])[0]["url"]: c.score for c in cands}


def _both(indexes, query, optic=None, max_candidates=50, **kw):
    """(jax {url: score}, port {url: score}) of one shard search."""
    ji, pi = indexes
    cj, _ = JaxLocal(ji, **kw).search_initial(JaxSQ(query=query, optic=optic),
                                              max_candidates=max_candidates)
    cp, _ = LocalSearcher(pi, **kw).search_initial(SearchQuery(query=query, optic=optic),
                                                   max_candidates=max_candidates)
    return _found(ji, cj), _found(pi, cp)


def _assert_same(fj: dict, fp: dict, exact: bool = True):
    """The same urls (exact: as sets) and scores within 1e-3, ties as sets."""
    if exact:
        assert set(fj) == set(fp)
    ids = {u: i for i, u in enumerate(sorted(set(fj) | set(fp)))}
    assert_topk_match(np.array([ids[u] for u in fj]), np.array(list(fj.values())),
                      np.array([ids[u] for u in fp]), np.array(list(fp.values())), -1,
                      1e-3, 1e-3)


# ---- tests/test_optic_compile.py's cases through both packages ------------------------
def test_discard_non_matching_beyond_topk_matches_jax(indexes):
    fj, fp = _both(indexes, "widget")
    assert not any("target.site" in u for u in fp)
    _assert_same(fj, fp, exact=False)
    fj, fp = _both(indexes, "widget", DNM_OPTIC)
    assert set(fp) == set(fj) == {f"https://target.site/p{i}" for i in range(3)}
    _assert_same(fj, fp)


def test_discard_rule_removes_from_candidates_matches_jax(indexes):
    fj, fp = _both(indexes, "guide")
    assert len(fp) == 3
    _assert_same(fj, fp)
    assert _both(indexes, "guide", DISCARD_OPTIC) == ({}, {})


def test_blocked_hosts_compiled_matches_jax(indexes):
    ji, pi = indexes
    pairs = []
    for mod, seg in ((optic_jax, ji.segments[0]), (optic_port, pi.segments[0])):
        o = mod.Optic.parse('Like(Site("x.com"));')
        o.host_rankings.blocked = ["target.site"]
        groups, _ = o.compile_groups()
        excl = [g for g in groups if g.excluded]
        assert len(excl) == 1
        pairs.append(sorted(excl[0].expand(seg)))
    assert pairs[0] == pairs[1]
    assert ("site_no_tokenizer", "www.target.site") in pairs[1]


def test_wildcard_site_pattern_matches_jax(indexes):
    fj, fp = _both(indexes, "widget", WILDCARD_OPTIC, max_candidates=250)
    assert fp and not any(u.startswith("https://noise1") for u in fp)
    assert any(u.startswith("https://noise2") for u in fp)
    _assert_same(fj, fp)


def test_value_dict_survives_merge_matches_jax(tmp_path):
    idx = JaxIndex(str(tmp_path / "vd"))
    idx.insert(make_doc("https://a.com/1", "alpha", "alpha body"))
    idx.commit()
    idx.insert(make_doc("https://b.com/1", "beta", "beta body"))
    idx.commit()
    idx.merge_all()
    port = InvertedIndex(idx.path, "cpu")
    for name in ("site", "domain"):
        assert port.segments[0].value_dict(name) == idx.segments[0].value_dict(name)
    assert set(port.segments[0].value_dict("site")) >= {"a.com", "b.com"}


@pytest.mark.parametrize("src", [CONTENT_DNM, BOOST_OPTIC])
def test_residual_cases_match_jax(src):
    """A content pattern under DiscardNonMatching compiles no required
    group; a boost stays in the residual and compiles no excluded group."""
    out = [mod.Optic.parse(src).compile_groups() for mod in (optic_jax, optic_port)]
    for groups, residual in out:
        assert not any(g.required or g.excluded for g in groups)
        assert residual.rules
    assert out[0][1].to_string() == out[1][1].to_string()
    assert out[0][1].discard_non_matching == out[1][1].discard_non_matching


# ---- the optic module against its original ------------------------------------------
def _groups_form(groups) -> list:
    return [(type(g).__name__, g.required, g.excluded, g.scoring, sorted(g.pairs),
             [(d, f, m.location.value, m.pattern) for d, f, m in g.patterns]) for g in groups]


@pytest.mark.parametrize("src", OPTICS)
def test_compile_groups_match_jax(src, indexes):
    """The same groups (pairs, patterns, flags), expanded alike against the
    same segment, and the same residual."""
    (gj, rj), (gp, rp) = (mod.Optic.parse(src).compile_groups() for mod in (optic_jax,
                                                                            optic_port))
    assert _groups_form(gj) == _groups_form(gp)
    ji, pi = indexes
    assert [g.expand(ji.segments[0]) for g in gj] == [g.expand(pi.segments[0]) for g in gp]
    assert (rp.to_string(), rp.discard_non_matching, rp.host_rankings.to_json()) == \
        (rj.to_string(), rj.discard_non_matching, rj.host_rankings.to_json())


@pytest.mark.parametrize("src", [
    'Rule { Matches { Bogus("x") } };', 'Rule { Action(Explode) };', 'Like(Domain("x"));',
    'Rule { Matches { Site(x) } };', "Rule { Matches { Site(\"x\") } ", '@', 'Foo;',
    'Rule { Action(Boost("3")) };', 'Rule { Matches { Site("a") }, Unknown };'])
def test_parse_errors_match_jax(src):
    errs = []
    for mod in (optic_jax, optic_port):
        with pytest.raises(mod.OpticError) as e:
            mod.Optic.parse(src)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


@pytest.mark.parametrize("src", OPTICS)
def test_to_string_round_trips(src):
    oj, op = optic_jax.Optic.parse(src), optic_port.Optic.parse(src)
    text = op.to_string()
    assert text == oj.to_string()
    back = optic_port.Optic.parse(text)
    assert back.to_string() == text
    assert (back.discard_non_matching, len(back.rules), back.host_rankings.to_json()) == \
        (op.discard_non_matching, len(op.rules), op.host_rankings.to_json())


class _Cand:
    def __init__(self, site, url, title, score):
        self.site, self.url, self.title, self.score = site, url, title, score


@pytest.mark.parametrize("src", OPTICS)
def test_apply_matches_jax(src):
    """Optic.apply keeps and re-scores the same candidates; blocked hosts
    drop theirs."""
    rng = np.random.default_rng(5)
    sites = ["a.com", "b.org", "noise3.com", "noise8.com", "target.site", "www.blocked.net"]

    def cands():
        r = np.random.default_rng(9)
        return [_Cand(s, f"https://{s}/p{i}", "a guide" if i % 2 else "x", float(r.normal()))
                for i, s in enumerate(sites * 3)]
    blocked = list(rng.choice(sites, 1))
    kept = []
    for mod in (optic_jax, optic_port):
        o = mod.Optic.parse(src)
        o.host_rankings.blocked = blocked
        out = o.apply(cands(), lambda c: {"site": c.site, "url": c.url, "title": c.title,
                                          "domain": c.site})
        kept.append([(c.url, c.score) for c in out])
    assert kept[0] == kept[1]


# ---- through the coordinator and the HTTP route --------------------------------------
@pytest.mark.parametrize("src", [DNM_OPTIC, WILDCARD_OPTIC, LIKES_OPTIC, CONTENT_DNM])
def test_optic_pages_match_jax(big_dir, src):
    """The coordinator's flow (shard plan, merge, optics residual in phase
    2, recall, page) gives the JAX package's page."""
    from test_torch_slice import _assert_pages_match, jax_searcher, port_searcher

    body = {"query": "widget", "optic": src, "numResults": 20}
    pj = jax_searcher(big_dir).search(JaxSQ.from_json(body)).to_json()
    pp = port_searcher(big_dir).search(SearchQuery.from_json(body)).to_json()
    _assert_pages_match(pj, pp)
    assert {w["url"] for w in pp["webpages"]} == {w["url"] for w in pj["webpages"]}
    if src == DNM_OPTIC:
        assert len(pp["webpages"]) == 3
    if src == CONTENT_DNM:  # no document holds "needle"
        assert pp["webpages"] == []


def test_optic_request_through_the_http_route(big_dir):
    from stract_tpu_torch.api.server import build_app
    from stract_tpu_torch.main import ServerThread
    from test_torch_slice import _assert_pages_match, jax_searcher, port_searcher

    body = {"query": "widget", "optic": DNM_OPTIC}
    server = ServerThread(build_app(port_searcher(big_dir), max_concurrency=4))
    try:
        req = urllib.request.Request(server.url + "/beta/api/search",
                                     data=json.dumps(body).encode(),
                                     headers={"content-type": "application/json"},
                                     method="POST")
        with urllib.request.urlopen(req, timeout=180) as resp:  # six workers share the cores
            assert resp.status == 200
            page = json.loads(resp.read())
    finally:
        server.stop()
    _assert_pages_match(jax_searcher(big_dir).search(JaxSQ.from_json(body)).to_json(), page)
    assert sorted(w["url"] for w in page["webpages"]) == \
        [f"https://target.site/p{i}" for i in range(3)]


def test_host_rankings_request_matches_jax(indexes):
    """A request's host rankings (SearchQuery.host_rankings, no optic) reach
    the query as the JAX package's do, and the search gives its results."""
    ji, pi = indexes
    hr = {"liked": ["noise5.com"], "disliked": ["noise6.com"], "blocked": []}
    cj, _ = JaxLocal(ji).search_initial(JaxSQ(query="widget", host_rankings=hr), 50)
    local = LocalSearcher(pi)
    sq = SearchQuery(query="widget", host_rankings=hr)
    assert local.parse_query(sq).host_rankings == hr
    cp, _ = local.search_initial(sq, 50)
    _assert_same(_found(ji, cj), _found(pi, cp))


# ---- the shard's linear model --------------------------------------------------------
WEIGHTS = {"host_centrality": 2.5, "bm25_title": 0.75, "title_coverage": -1.25,
           "bm25_clean_body": 0.5}


@pytest.mark.parametrize("query", ["widget", "widget guide", "catalog deals"])
def test_linear_model_pages_match_jax(indexes, query):
    """LocalSearcher(linear_model=...): pass 2 runs at search time and the
    model's predictions move the scores, as in the JAX package."""
    ji, pi = indexes
    fj, fp = _both(indexes, query, max_candidates=300,
                   linear_model=None)  # the model off: the baseline scores
    lj = JaxLinear(WEIGHTS, intercept=0.125)
    lp = LinearRegression.from_json(lj.to_json())
    assert lp.to_json() == lj.to_json()
    local = LocalSearcher(pi, linear_model=lp)
    assert not local.lazy_signals
    cj, _ = JaxLocal(ji, linear_model=lj).search_initial(JaxSQ(query=query), 300)
    cp, _ = local.search_initial(SearchQuery(query=query), 300)
    gj, gp = _found(ji, cj), _found(pi, cp)
    _assert_same(gj, gp)
    assert all(c.signals is not None for c in cp)
    assert any(abs(gp[u] - fp[u]) > 1e-2 for u in gp)  # the model moved the scores
    rows = np.stack([c.signals for c in cp])
    np.testing.assert_allclose(lp.predict(rows), lj.predict(rows), rtol=1e-6, atol=1e-6)


def test_linear_model_through_the_search_service(indexes, tmp_path):
    """SearchService with the model loaded from JSON, as `run` loads
    linear_model_path: the wire candidates' scores equal the JAX service's."""
    from stract_tpu.entrypoint.search_server import SearchService as JaxService
    from stract_tpu_torch.entrypoint.search_server import SearchService

    ji, pi = indexes
    path = tmp_path / "linear.json"
    path.write_text(JaxLinear(WEIGHTS, intercept=0.125).to_json())
    lp = LinearRegression.from_json(path.read_text())
    lj = JaxLinear.from_json(path.read_text())
    svc_j = JaxService(ji, linear_model=lj, batching=False, mesh=None)
    svc_p = SearchService(pi, linear_model=lp, batching=False, mesh=None)
    for body in ({"query": "widget"}, {"query": "widget guide", "optic": LIKES_OPTIC}):
        rj, rp = svc_j.search(body), svc_p.search(body)
        assert rj["count"] == rp["count"]
        fj = {(c["segment"], c["doc"]): c["score"] for c in rj["candidates"]}
        fp = {(c["segment"], c["doc"]): c["score"] for c in rp["candidates"]}
        ids = {k: i for i, k in enumerate(sorted(set(fj) | set(fp)))}
        assert_topk_match(np.array([ids[k] for k in fj]), np.array(list(fj.values())),
                          np.array([ids[k] for k in fp]), np.array(list(fp.values())), -1,
                          1e-3, 1e-3)
