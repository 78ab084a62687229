/* stract_tpu SPA (role of the reference SvelteKit frontend: search SERP with
   sidebar/widget/spellcheck, explore similar-sites with optic export, settings
   with region/safe-search + optics manager). Client-side routing over the
   HTTP JSON API; settings live in localStorage. */
"use strict";

const $ = (sel, el) => (el || document).querySelector(sel);
const view = $("#view");
const qInput = $("#q");

// ---- settings ---------------------------------------------------------------
const SETTINGS_KEY = "stract_settings";
function settings() {
  try { return JSON.parse(localStorage.getItem(SETTINGS_KEY)) || {}; }
  catch { return {}; }
}
function saveSettings(s) { localStorage.setItem(SETTINGS_KEY, JSON.stringify(s)); }
function activeOptic() {
  const s = settings();
  const o = (s.optics || []).find((o) => o.name === s.activeOptic);
  return o ? o.source : null;
}

// ---- api --------------------------------------------------------------------
async function api(path, body) {
  const res = await fetch(path, body === undefined ? {} : {
    method: "POST",
    headers: { "content-type": "application/json" },
    body: JSON.stringify(body),
  });
  if (!res.ok) throw new Error(`${path}: ${res.status}`);
  return res.json();
}

function esc(s) {
  return String(s ?? "").replace(/[&<>"']/g, (c) => ({
    "&": "&amp;", "<": "&lt;", ">": "&gt;", '"': "&quot;", "'": "&#39;",
  })[c]);
}
// snippet_html from the API only ever contains <b> highlights — keep those,
// escape everything else
function snippetHtml(w) {
  if (w.snippet_html) {
    return esc(w.snippet_html).replace(/&lt;(\/?)b&gt;/g, "<$1b>");
  }
  return esc(w.snippet || "");
}

// ---- routing ------------------------------------------------------------------
function navigate(url, push = true) {
  if (push) history.pushState(null, "", url);
  render();
}
window.addEventListener("popstate", () => render());
document.addEventListener("click", (e) => {
  const a = e.target.closest("a[data-nav]");
  if (a) { e.preventDefault(); navigate(a.getAttribute("href")); }
});

function render() {
  const path = location.pathname;
  const params = new URLSearchParams(location.search);
  hideSuggestions();
  if (path === "/search" && params.get("q")) {
    qInput.value = params.get("q");
    renderSearch(params.get("q"), parseInt(params.get("p") || "0", 10));
  } else if (path === "/explore") {
    renderExplore();
  } else if (path === "/settings") {
    renderSettings();
  } else if (path === "/about" || path === "/webmasters" || path === "/privacy") {
    renderArticle(path.slice(1));
  } else {
    qInput.value = "";
    view.innerHTML = `<div class="hero"><h1>stract_tpu</h1>
      <p>a TPU-native open web search engine</p>
      <p class="meta"><a data-nav href="/about">about</a> ·
        <a data-nav href="/webmasters">webmasters</a> ·
        <a data-nav href="/privacy">privacy</a></p></div>`;
  }
}

// ---- article pages (reference routes/{about,webmasters,privacy-*}) -------------
const ARTICLES = {
  about: `
    <h1>About</h1>
    <p>stract_tpu is an open web search engine whose entire compute path —
    retrieval, scoring, and neural reranking — runs as compiled XLA programs
    on TPU hardware. One index segment is a set of flat arrays that memory-map
    on the host and upload to device HBM unchanged; a query batch is a handful
    of device program dispatches.</p>
    <h2>How ranking works</h2>
    <p>Results are ranked in stages: a device candidate scan over impact-ordered
    posting prefixes, an exact verification pass over full posting ranges, and
    optional neural stages (dual-encoder recall, LambdaMART, cross-encoder
    precision). Signals include text relevance (BM25 over dozens of fields),
    host/page centrality from the webgraph, freshness, and region match. Every
    signal coefficient can be tuned per query or packaged as an optic.</p>
    <h2>Optics</h2>
    <p>Optics are small rule files that re-rank, boost, or exclude sites.
    They compile into the device candidate-generation program, so your rules
    run at search speed rather than as a post-filter. Manage them under
    <a data-nav href="/settings">settings</a>.</p>`,
  webmasters: `
    <h1>Webmasters</h1>
    <p>StractTpuBot collects pages to build this index. It identifies itself
    with the user agent token <code>StractTpuBot</code>.</p>
    <h2>Politeness</h2>
    <p>The crawler runs one site-exclusive job at a time per domain, so your
    server never sees concurrent requests from us. It waits at least one
    second between fetches on the same site, honors
    <code>Crawl-delay</code> from robots.txt, and never waits less than that
    value (capped at 180 seconds).</p>
    <h2>429 handling</h2>
    <p>On a <code>429 Too Many Requests</code> response the delay for that
    domain doubles (up to the 180 second cap) and the fetch is retried at the
    increased delay; after three slow-downs the URL is abandoned for the
    crawl.</p>
    <h2>robots.txt</h2>
    <p>StractTpuBot follows RFC 9309. To keep it out of part of your site:</p>
    <pre>User-agent: StractTpuBot
Disallow: /private</pre>
    <p>To exclude it entirely, disallow <code>/</code>. Rules are re-fetched
    at the start of every site job.</p>`,
  privacy: `
    <h1>Privacy</h1>
    <p>Searches are not profiled. The engine keeps no per-user history and
    serves results without tracking identifiers.</p>
    <h2>What is stored</h2>
    <p>Your interface preferences (region, safe search, enabled optics) live
    in your browser's local storage and are sent only as parameters of the
    searches you make. Aggregate, anonymous counters (query volume via a
    HyperLogLog sketch, latency histograms) feed the metrics endpoint; they
    cannot be traced back to a user.</p>
    <h2>Improvement queue</h2>
    <p>If you explicitly enable result-improvement feedback in settings, the
    clicked result positions for a query are stored without any user
    identifier and used to train ranking models.</p>`,
};

function renderArticle(name) {
  qInput.value = "";
  view.innerHTML = `<article class="article">${ARTICLES[name]}</article>`;
}

// ---- search -------------------------------------------------------------------
let searchSeq = 0;
async function renderSearch(q, page) {
  const seq = ++searchSeq;
  view.innerHTML = `<div class="meta">searching…</div>`;
  const s = settings();
  const body = {
    query: q,
    page,
    safeSearch: s.safeSearch !== false,
    selectedRegion: s.region || 0,
    returnRankingSignals: !!s.showSignals,
  };
  const optic = activeOptic();
  if (optic) body.optic = optic;

  let data, sidebar = null, widget = null;
  try {
    [data, widget, sidebar] = await Promise.all([
      api("/beta/api/search", body),
      api("/beta/api/search/widget", { query: q }).then((r) => r.widget).catch(() => null),
      api("/beta/api/search/sidebar", { query: q }).then((r) => r.sidebar).catch(() => null),
    ]);
  } catch (e) {
    if (seq === searchSeq) view.innerHTML = `<p class="err">search failed: ${esc(e.message)}</p>`;
    return;
  }
  if (seq !== searchSeq) return;

  if (data.type === "bang") { location.href = data.redirectTo; return; }

  let html = `<div class="serp"><div class="results">`;
  const n = data.numHits || {};
  html += `<div class="meta">${n.exact ? "" : "about "}${(n.value ?? 0).toLocaleString()} results
    · ${Math.round(data.searchDurationMs || 0)} ms</div>`;

  const corr = await api("/beta/api/search/spellcheck", { query: q })
    .then((r) => r.correction).catch(() => null);
  if (seq !== searchSeq) return;
  if (corr && corr.corrected && corr.corrected !== q) {
    html += `<div class="correction">Did you mean
      <a data-nav href="/search?q=${encodeURIComponent(corr.corrected)}"><b>${esc(corr.corrected)}</b></a>?</div>`;
  }
  if (widget && widget.result !== undefined) {
    html += `<div class="widget"><div class="big">${esc(widget.result)}</div>
      <div class="meta">${esc(widget.type || "calculator")}: ${esc(widget.input || q)}</div></div>`;
  } else if (widget && widget.type === "thesaurus") {
    const meanings = (widget.meanings || []).slice(0, 3).map((m) =>
      `<div><i>${esc(m.pos)}</i> ${esc(m.definition)}
       ${m.synonyms?.length ? `<span class="meta">syn: ${esc(m.synonyms.join(", "))}</span>` : ""}</div>`
    ).join("");
    html += `<div class="widget"><b>${esc(widget.term)}</b>${meanings}</div>`;
  }

  for (const w of data.webpages || []) {
    html += `<div class="result">
      <div class="url">${esc(w.url)}</div>
      <h3><a href="${esc(w.url)}">${esc(w.title || w.url)}</a></h3>
      <div class="snippet">${snippetHtml(w)}</div>`;
    // StackOverflow QA rich snippet (reference search/StackOverflowSnippet.svelte)
    const qa = w.richSnippet;
    if (qa && qa.type === "stackOverflowQA") {
      const passages = (ps) => ps.map((p) =>
        p.kind === "code" ? `<pre class="so-code">${esc(p.value)}</pre>`
                          : `<p>${esc(p.value)}</p>`).join("");
      html += `<div class="so-qa">`;
      for (const a of qa.answers || []) {
        html += `<div class="so-answer${a.accepted ? " accepted" : ""}">
          <span class="so-votes">▲ ${a.upvotes}${a.accepted ? " ✓" : ""}</span>
          <div class="so-body">${passages(a.body)}
            <span class="meta">answered ${esc(a.date)} · <a href="${esc(a.url)}">source</a></span>
          </div></div>`;
      }
      html += `</div>`;
    }
    html += `<div class="actions">
        <a data-site="${esc(w.site)}" class="more-from">more from ${esc(w.site)}</a>
      </div>`;
    if (w.rankingSignals) {
      const sig = Object.entries(w.rankingSignals)
        .sort((a, b) => Math.abs(b[1]) - Math.abs(a[1])).slice(0, 12)
        .map(([k, v]) => `${k}=${v.toFixed(4)}`).join("  ");
      html += `<div class="signals">${esc(sig)}</div>`;
    }
    html += `</div>`;
  }
  if (!(data.webpages || []).length) html += `<p>No results for <b>${esc(q)}</b>.</p>`;

  html += `<div class="pager">
    <button id="prev" ${page <= 0 ? "disabled" : ""}>← Previous</button>
    <button id="next" ${data.hasMoreResults ? "" : "disabled"}>Next →</button>
  </div></div>`;

  if (sidebar && sidebar.type === "entity" && (sidebar.value || sidebar.entity)) {
    const ent = sidebar.value || sidebar.entity;
    html += `<aside class="sidebar">`;
    if (ent.image) html += `<img src="/beta/api/entity_image?imageId=${encodeURIComponent(ent.image)}" alt="">`;
    html += `<h3>${esc(ent.title)}</h3><div class="abstract">${esc(ent.abstract || "").slice(0, 500)}</div>`;
    const info = ent.info || {};
    const rows = Object.entries(info).slice(0, 8)
      .map(([k, v]) => `<tr><td>${esc(k)}</td><td>${esc(v)}</td></tr>`).join("");
    if (rows) html += `<table>${rows}</table>`;
    html += `</aside>`;
  } else if (sidebar && sidebar.type === "stackOverflow") {
    // accepted-answer card (reference search/Sidebar.svelte stackOverflow arm)
    const a = sidebar.answer || {};
    const passages = (a.body || []).map((p) =>
      p.kind === "code" ? `<pre class="so-code">${esc(p.value)}</pre>`
                        : `<p>${esc(p.value)}</p>`).join("");
    html += `<aside class="sidebar"><h3>${esc(sidebar.title)}</h3>
      <div class="so-answer accepted"><span class="so-votes">▲ ${a.upvotes ?? 0} ✓</span>
      <div class="so-body">${passages}
        <span class="meta">answered ${esc(a.date || "")} · <a href="${esc(a.url || "#")}">source</a></span>
      </div></div></aside>`;
  }
  html += `</div>`;
  view.innerHTML = html;

  $("#prev")?.addEventListener("click", () =>
    navigate(`/search?q=${encodeURIComponent(q)}&p=${page - 1}`));
  $("#next")?.addEventListener("click", () =>
    navigate(`/search?q=${encodeURIComponent(q)}&p=${page + 1}`));
  view.querySelectorAll(".more-from").forEach((a) =>
    a.addEventListener("click", () =>
      navigate(`/search?q=${encodeURIComponent(`site:${a.dataset.site} ${q}`)}`)));

  // improvement store (click logging for LTR, reference improvement.rs)
  api("/improvement/store", { query: q, urls: (data.webpages || []).map((w) => w.url) })
    .catch(() => {});
}

// ---- explore (similar sites, reference routes/explore) --------------------------
async function renderExplore() {
  const s = settings();
  const chosen = s.exploreChosen || [];
  view.innerHTML = `<div class="explore">
    <h2>Explore similar sites</h2>
    <p class="meta">Add sites you like — we find more like them via webgraph inbound similarity.</p>
    <div class="host-row">
      <input type="text" id="host-in" placeholder="example.com">
      <button id="host-add">Add</button>
      <button id="export-optic" ${chosen.length ? "" : "disabled"}>Export as optic</button>
    </div>
    <div id="chosen">${chosen.map((h) =>
      `<span class="chip">${esc(h)} <a data-del="${esc(h)}">✕</a></span>`).join("")}</div>
    <div class="similar" id="similar"></div>
    <pre id="optic-out" class="signals hidden"></pre>
  </div>`;

  const refresh = async () => {
    if (!chosen.length) { $("#similar").innerHTML = ""; return; }
    $("#similar").innerHTML = `<div class="meta">finding similar sites…</div>`;
    try {
      const sims = await api("/beta/api/webgraph/host/similar", { hosts: chosen, topN: 20 });
      $("#similar").innerHTML = `<h3>Similar sites</h3>` + sims.map((r) =>
        `<span class="chip">${esc(r.host)}<span class="score">${r.score.toFixed(3)}</span>
         <a data-add="${esc(r.host)}">+</a></span>`).join("");
      $("#similar").querySelectorAll("[data-add]").forEach((a) =>
        a.addEventListener("click", () => { addHost(a.dataset.add); }));
    } catch {
      $("#similar").innerHTML = `<p class="meta">webgraph not available</p>`;
    }
  };
  const addHost = (h) => {
    h = h.trim().replace(/^https?:\/\//, "").replace(/\/.*/, "");
    if (h && !chosen.includes(h)) {
      chosen.push(h);
      saveSettings({ ...settings(), exploreChosen: chosen });
      renderExplore();
    }
  };
  $("#host-add").addEventListener("click", () => addHost($("#host-in").value));
  $("#host-in").addEventListener("keydown", (e) => {
    if (e.key === "Enter") addHost($("#host-in").value);
  });
  view.querySelectorAll("[data-del]").forEach((a) =>
    a.addEventListener("click", () => {
      saveSettings({ ...settings(), exploreChosen: chosen.filter((x) => x !== a.dataset.del) });
      renderExplore();
    }));
  $("#export-optic").addEventListener("click", async () => {
    const sims = await api("/beta/api/webgraph/host/similar", { hosts: chosen, topN: 20 })
      .catch(() => []);
    const res = await fetch("/beta/api/explore/export", {
      method: "POST", headers: { "content-type": "application/json" },
      body: JSON.stringify({ chosenHosts: chosen, similarHosts: sims.map((r) => r.host) }),
    });
    const text = await res.text();
    const out = $("#optic-out");
    out.textContent = text;
    out.classList.remove("hidden");
  });
  refresh();
}

// ---- settings (region, safe search, optics manager — reference routes/settings) --
function renderSettings() {
  const s = settings();
  const optics = s.optics || [];
  view.innerHTML = `<div class="settings">
    <h2>Settings</h2>
    <section>
      <h3>Search</h3>
      <label>Region:
        <select id="region">
          <option value="0">All</option><option value="1">US</option>
          <option value="2">EU</option><option value="3">UK</option>
          <option value="4">DE</option><option value="5">FR</option>
        </select>
      </label>
      &nbsp;&nbsp;
      <label><input type="checkbox" id="safesearch"> Safe search</label>
      &nbsp;&nbsp;
      <label><input type="checkbox" id="signals"> Show ranking signals</label>
    </section>
    <section>
      <h3>Optics</h3>
      <p class="meta">User-defined result filters and boosts (the optics DSL).
        The active optic applies to every search.</p>
      <div id="optic-list">${optics.map((o) => `
        <div class="optic-row">
          <label><input type="radio" name="active" value="${esc(o.name)}"
            ${s.activeOptic === o.name ? "checked" : ""}> ${esc(o.name)}</label>
          <a data-edit="${esc(o.name)}">edit</a>
          <a data-remove="${esc(o.name)}">remove</a>
        </div>`).join("")}
        <div class="optic-row">
          <label><input type="radio" name="active" value=""
            ${!s.activeOptic ? "checked" : ""}> none</label>
        </div>
      </div>
      <h4 id="editor-title">New optic</h4>
      <input type="text" id="optic-name" placeholder="name">
      <textarea id="optic-src" placeholder='Rule {\n    Matches {\n        Site("|example.com|")\n    },\n    Action(Boost(3))\n};'></textarea>
      <div><button id="optic-save">Save optic</button> <span id="optic-msg"></span></div>
    </section>
  </div>`;

  $("#region").value = String(s.region || 0);
  $("#safesearch").checked = s.safeSearch !== false;
  $("#signals").checked = !!s.showSignals;
  $("#region").addEventListener("change", (e) =>
    saveSettings({ ...settings(), region: parseInt(e.target.value, 10) }));
  $("#safesearch").addEventListener("change", (e) =>
    saveSettings({ ...settings(), safeSearch: e.target.checked }));
  $("#signals").addEventListener("change", (e) =>
    saveSettings({ ...settings(), showSignals: e.target.checked }));
  view.querySelectorAll('input[name="active"]').forEach((r) =>
    r.addEventListener("change", (e) =>
      saveSettings({ ...settings(), activeOptic: e.target.value || null })));
  view.querySelectorAll("[data-edit]").forEach((a) =>
    a.addEventListener("click", () => {
      const o = optics.find((o) => o.name === a.dataset.edit);
      $("#optic-name").value = o.name;
      $("#optic-src").value = o.source;
      $("#editor-title").textContent = `Edit ${o.name}`;
    }));
  view.querySelectorAll("[data-remove]").forEach((a) =>
    a.addEventListener("click", () => {
      const st = settings();
      st.optics = (st.optics || []).filter((o) => o.name !== a.dataset.remove);
      if (st.activeOptic === a.dataset.remove) st.activeOptic = null;
      saveSettings(st);
      renderSettings();
    }));
  $("#optic-save").addEventListener("click", async () => {
    const name = $("#optic-name").value.trim();
    const source = $("#optic-src").value;
    const msg = $("#optic-msg");
    if (!name) { msg.textContent = "name required"; msg.className = "err"; return; }
    // instant client-side parse (optic.js, role of the reference client-wasm)
    try {
      OpticClient.parse(source);
    } catch (e) {
      msg.textContent = `parse error: ${e.message}`; msg.className = "err"; return;
    }
    // then validate against the server's parser too
    try {
      await api("/beta/api/search", { query: "test", optic: source, numResults: 1 });
    } catch {
      msg.textContent = "optic failed server-side validation"; msg.className = "err"; return;
    }
    const st = settings();
    st.optics = (st.optics || []).filter((o) => o.name !== name);
    st.optics.push({ name, source });
    saveSettings(st);
    msg.textContent = "saved"; msg.className = "ok";
    renderSettings();
  });
}

// ---- autosuggest ----------------------------------------------------------------
let sugTimer = null, sugSel = -1;
function hideSuggestions() { $("#suggestions").classList.add("hidden"); sugSel = -1; }
qInput.addEventListener("input", () => {
  clearTimeout(sugTimer);
  const q = qInput.value.trim();
  if (!q) { hideSuggestions(); return; }
  sugTimer = setTimeout(async () => {
    try {
      const res = await api(`/beta/api/autosuggest?q=${encodeURIComponent(q)}`);
      const box = $("#suggestions");
      if (!res.length) { hideSuggestions(); return; }
      box.innerHTML = res.map((r) => `<div>${esc(r.raw)}</div>`).join("");
      box.classList.remove("hidden");
      box.querySelectorAll("div").forEach((d) =>
        d.addEventListener("mousedown", () => {
          qInput.value = d.textContent;
          submitSearch();
        }));
    } catch { hideSuggestions(); }
  }, 120);
});
qInput.addEventListener("keydown", (e) => {
  const box = $("#suggestions");
  const items = box.querySelectorAll("div");
  if (box.classList.contains("hidden") || !items.length) return;
  if (e.key === "ArrowDown" || e.key === "ArrowUp") {
    e.preventDefault();
    sugSel = (sugSel + (e.key === "ArrowDown" ? 1 : -1) + items.length) % items.length;
    items.forEach((d, i) => d.classList.toggle("sel", i === sugSel));
    qInput.value = items[sugSel].textContent;
  } else if (e.key === "Escape") {
    hideSuggestions();
  }
});
document.addEventListener("click", (e) => {
  if (!e.target.closest(".searchbox")) hideSuggestions();
});

function submitSearch() {
  const q = qInput.value.trim();
  if (q) navigate(`/search?q=${encodeURIComponent(q)}`);
}
$("#searchform").addEventListener("submit", (e) => { e.preventDefault(); submitSearch(); });

render();
