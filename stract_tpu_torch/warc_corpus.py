"""Seeded WARC files of pages shaped like crawled ones, for the indexing
pipeline's smoke run and its parity tests.

Each page has a title (ending in a token of its own, `unique_token`), a meta
description, h1-h3 headings, a body of paragraphs (`words` long, mostly
English, one page in eight in another language detect_lang knows, with its
<html lang>), 20-60 links over the corpus's hosts (some rel=nofollow, ugc or
sponsored, some in a <nav> or <footer>, a canonical <link> on some), JSON-LD
on one page in ten, schema.org microdata on one in twenty, a tracker script
on one in eight and a robots noindex on one in fifty.

    write_warcs(out_dir, files=2, pages=1000, seed=0) -> CorpusInfo
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

import numpy as np

from .warc import WarcWriter

# a fixed date: the records' bytes depend on the seed alone (and the record ids)
WARC_DATE = "2024-01-01T00:00:00Z"

EN_STOP = ("the and of to in is that for with you this a on as by at from it be are was "
            "or an not have has but which their its can will more about").split()
EN_STEMS = ("connect run search index rank engine crawl page link host graph query result "
             "relevant score learn model train network language program system develop build "
             "design test measure compute process store retriev document term token weight "
             "central harmon estimat distribut server cluster shard replic commit merg segment "
             "post frequenc signal featur optim perform latenc throughput memor cach batch "
             "kernel devic transform encod embed vector dens spars attent layer norm pool "
             "garden cook recip travel histor scienc music polit sport market financ health "
             "educat famil weather nation communit environ energi transport agricultur").split()
_EN_SUFFIXES = ("", "", "s", "ed", "ing", "ion", "ions", "er", "ers", "ly", "ness", "ment",
                "ments", "al", "ally", "ation", "ations", "ive", "ity", "ies", "able")
_OTHER = {
    "de": ("der die und das ist nicht ein mit für auf häuser laufen läuft gelaufen "
           "suchmaschine suchmaschinen ergebnisse ergebnis verbindungen verbindung "
           "schnellen schneller wichtigsten wichtig entwicklung entwickelt bücher buch "
           "kinder kindern städte stadt wohnungen arbeiten arbeitete").split(),
    "fr": ("le la les et des est pour dans que une moteurs moteur recherche recherches "
           "résultats résultat connexions connexion rapidement rapide développement "
           "développer chevaux cheval mangeons manger villes ville travaillons travail "
           "nationales nationale").split(),
    "es": ("el la los de que y en un por con para motores motor búsqueda búsquedas "
           "resultados resultado conexiones conexión rápidamente rápido desarrollo "
           "desarrollar ciudades ciudad trabajando trabajo nacionales nacional").split(),
    "it": ("il la di che e un per con del una motori motore ricerca ricerche risultati "
           "risultato connessioni connessione rapidamente rapido sviluppo sviluppare "
           "città lavorando lavoro nazionali nazionale").split(),
    "pt": ("o a de que e um para com não uma motores motor pesquisa pesquisas resultados "
           "resultado conexões conexão rapidamente rápido desenvolvimento desenvolver "
           "cidades cidade trabalhando trabalho nacionais nacional").split(),
    "nl": ("de het een en van is dat op voor met zoekmachines zoekmachine resultaten "
           "resultaat verbindingen verbinding snelle sneller ontwikkeling ontwikkelen "
           "steden stad werkende werken nationale").split(),
    "sv": ("och det är att en som för med på inte sökmotorer sökmotor resultaten "
           "resultat anslutningar anslutning snabbare snabb utvecklingen utveckla "
           "städerna stad arbetande arbete nationella").split(),
    "da": ("og det er til en af for med på ikke søgemaskiner søgemaskine resultaterne "
           "resultat forbindelser forbindelse hurtigere hurtig udviklingen udvikle "
           "byerne by arbejdende arbejde nationale kærlighed").split(),
    "ru": ("и в не на что это как с по из поисковые поисковая системы система "
           "результаты результат соединения соединение быстрее быстрый развитие "
           "развивать города город работающие работа национальные").split(),
    "pl": ("i w nie na to się jest do z że wyszukiwarki wyszukiwarka wyniki wynik "
           "połączenia połączenie szybciej szybki rozwój rozwijać miasta miasto").split(),
}
_LANGS = tuple(_OTHER)
_RELS = ("nofollow", "ugc", "sponsored", "noopener", "external", "author", "tag", "me")
_TRACKERS = ("https://www.googletagmanager.com/gtm.js", "https://static.doubleclick.net/ad.js",
             "https://connect.facebook.net/sdk.js")


@dataclass
class CorpusInfo:
    paths: list                      # the WARC files
    pages: int = 0
    noindex: int = 0                 # pages with a robots noindex
    hosts: list = field(default_factory=list)
    unique: dict = field(default_factory=dict)  # url → the title's own token


def unique_token(seed: int, i: int) -> str:
    return f"qz{seed}u{i}x"


def _en_words(rng, n: int) -> list:
    stems = rng.integers(0, len(EN_STEMS), n)
    sufs = rng.integers(0, len(_EN_SUFFIXES), n)
    stop = rng.random(n) < 0.35
    stops = rng.integers(0, len(EN_STOP), n)
    return [EN_STOP[stops[k]] if stop[k] else EN_STEMS[stems[k]] + _EN_SUFFIXES[sufs[k]]
            for k in range(n)]


def _words(rng, lang: str, n: int) -> list:
    if lang == "en":
        return _en_words(rng, n)
    vocab = _OTHER[lang]
    return [vocab[k] for k in rng.integers(0, len(vocab), n)]


def _sentences(rng, words: list) -> str:
    out, k = [], 0
    while k < len(words):
        m = int(rng.integers(6, 18))
        s = words[k:k + m]
        k += m
        out.append(s[0].capitalize() + " " + " ".join(s[1:]) + "." if len(s) > 1
                   else s[0].capitalize() + ".")
    return " ".join(out)


def page(rng, seed: int, i: int, hosts: list, words: tuple = (300, 1500)) -> tuple:
    """One page → (url, html, noindex)."""
    if i < len(hosts) and i % 4 == 0:  # a homepage (one a host at most)
        url = f"https://{hosts[i]}/"
    else:
        host = hosts[int(rng.integers(len(hosts)))]
        url = f"https://{host}/{EN_STEMS[i % len(EN_STEMS)]}/{i}"
    lang = "en" if rng.random() < 7 / 8 else _LANGS[int(rng.integers(len(_LANGS)))]
    title_words = _words(rng, lang, int(rng.integers(2, 7)))
    title = " ".join(title_words).capitalize() + " " + unique_token(seed, i)
    desc = _sentences(rng, _words(rng, lang, int(rng.integers(10, 30))))
    noindex = i % 50 == 7
    head = [f"<title>{title}</title>", '<meta charset="utf-8">',
            f'<meta name="description" content="{desc}">']
    if noindex:
        head.append('<meta name="robots" content="noindex, nofollow">')
    r = rng.random()
    if r < 0.3:  # to itself, or to the page's canonical copy
        canon = url if r < 0.15 else url.rstrip("/") + "/canonical"
        head.append(f'<link rel="canonical" href="{canon}">')
    head.append('<link rel="stylesheet" href="/style.css">')
    if i % 8 == 3:
        head.append(f'<script src="{_TRACKERS[i % len(_TRACKERS)]}"></script>')
    if i % 10 == 1:
        ld = {"@context": "https://schema.org", "@type": "Article", "headline": title,
              "author": {"@type": "Person", "name": " ".join(_words(rng, lang, 2))},
              "keywords": _words(rng, lang, 3)}
        head.append(f'<script type="application/ld+json">{json.dumps(ld)}</script>')

    n_words = int(rng.integers(words[0], words[1] + 1))
    body_words = _words(rng, lang, n_words)
    n_links = int(rng.integers(20, 61))
    link_html = []
    for _ in range(n_links):
        dest = hosts[int(rng.integers(len(hosts)))]
        path = "" if rng.random() < 0.3 else f"{EN_STEMS[int(rng.integers(len(EN_STEMS)))]}"
        rel = f' rel="{_RELS[int(rng.integers(len(_RELS)))]}"' if rng.random() < 0.2 else ""
        anchor = " ".join(_words(rng, lang, int(rng.integers(1, 4))))
        link_html.append(f'<a href="https://{dest}/{path}"{rel}>{anchor}</a>')
    body = [f"<h1>{title}</h1>"]
    k = 0
    n_sections = max(1, n_words // 200)
    per = (n_words + n_sections - 1) // n_sections
    inline = link_html[: n_links // 2]
    for s in range(n_sections):
        body.append(f"<h2>{' '.join(_words(rng, lang, 3)).capitalize()}</h2>")
        chunk = body_words[k:k + per]
        k += per
        for p0 in range(0, len(chunk), 60):
            text = _sentences(rng, chunk[p0:p0 + 60])
            if inline and rng.random() < 0.5:
                text += " " + inline.pop()
            body.append(f"<p>{text}</p>")
        if s % 2 == 1:
            body.append(f"<h3>{' '.join(_words(rng, lang, 2)).capitalize()}</h3>")
    if i % 20 == 9:
        body.append('<div itemscope itemtype="https://schema.org/Recipe">'
                    f'<span itemprop="name">{" ".join(_words(rng, lang, 2))}</span>'
                    f'<span itemprop="recipeIngredient">{_words(rng, lang, 1)[0]}</span>'
                    '<div itemprop="author" itemscope itemtype="https://schema.org/Person">'
                    f'<span itemprop="name">{_words(rng, lang, 1)[0]}</span></div></div>')
    rest = link_html[n_links // 2:] + inline
    nav, foot = rest[: len(rest) // 2], rest[len(rest) // 2:]
    html = (f'<!DOCTYPE html>\n<html lang="{lang}">\n<head>\n' + "\n".join(head)
            + "\n</head>\n<body>\n<nav>" + " ".join(nav) + "</nav>\n<main>\n"
            + "\n".join(body) + "\n</main>\n<footer>" + " ".join(foot)
            + "</footer>\n</body>\n</html>\n")
    return url, html, noindex


def write_warcs(out_dir: str, files: int = 2, pages: int = 1000, seed: int = 0,
                hosts: int = 500, words: tuple = (300, 1500)) -> CorpusInfo:
    """`files` WARC files of `pages` pages each over `hosts` hosts."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    host_names = [f"www.site{h}.{('com', 'org', 'net', 'de', 'fr')[h % 5]}" for h in range(hosts)]
    info = CorpusInfo(paths=[], hosts=host_names)
    i = 0
    for f in range(files):
        path = os.path.join(out_dir, f"corpus-{seed}-{f}.warc.gz")
        with WarcWriter.open(path) as w:
            for _ in range(pages):
                url, html, noindex = page(rng, seed, i, host_names, words)
                w.write_record(url, html, date=WARC_DATE)
                info.pages += 1
                info.noindex += int(noindex)
                if not noindex:
                    info.unique[url] = unique_token(seed, i)
                i += 1
        info.paths.append(path)
    return info
