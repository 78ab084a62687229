"""The port's stemmer against NLTK's Snowball stemmers, which the JAX package
stems with: every distinct token of seeded pages (stract_tpu_torch/warc_corpus.py,
every language the pages are written in) stemmed in each of the ten languages
the port carries (tokenizer/snowball.py), a list of inflected forms for each
language, and the port's stem with NLTK hidden (it stems, where the port once
fell back to the token unchanged). Exact equality throughout.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest

from stract_tpu_torch import warc_corpus as WC
from stract_tpu_torch.tokenizer import stemmer as port_stemmer
from stract_tpu_torch.tokenizer import tokenize

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LANGS = {"en": "english", "de": "german", "fr": "french", "es": "spanish", "da": "danish",
         "sv": "swedish", "it": "italian", "pt": "portuguese", "ru": "russian", "nl": "dutch"}
INFLECTED = {
    "en": "running runs ran connections connected connecting ponies caresses generously "
          "relational hopefully sky skies dying lying news proceed exceeding succeeded "
          "happily national nationalization agreement agreed feed owned".split(),
    "de": "häuser laufen läuft gelaufen aufeinanderfolgenden kategorischen "
          "schlüsselwörter wohnungen arbeitete kindern bücher städte".split(),
    "fr": "continuellement chevaux mangeons nationales développement connexions "
          "rapidement travaillons abaissement abandonnée".split(),
    "es": "búsquedas rápidamente conexiones desarrollar ciudades nacionales trabajando "
          "abarcaba comiendo".split(),
    "da": "kærlighed søgemaskiner forbindelser hurtigere udviklingen byerne arbejdende".split(),
    "sv": "sökmotorer anslutningar snabbare utvecklingen städerna arbetande nationella".split(),
    "it": "abbandonata connessioni rapidamente sviluppare città lavorando nazionali".split(),
    "pt": "desenvolvimento conexões rapidamente cidades trabalhando nacionais".split(),
    "ru": "поисковые системы результаты соединения быстрее развитие города работающие".split(),
    "nl": "zoekmachines resultaten verbindingen ontwikkeling steden werkende nationale".split(),
}


@pytest.fixture(scope="module")
def page_tokens():
    rng = np.random.default_rng(26)
    hosts = [f"www.site{h}.com" for h in range(40)]
    toks = set()
    for i in range(200):
        _, html, _ = WC.page(rng, 0, i, hosts, (40, 200))
        toks.update(tokenize(html))
    return sorted(t for t in toks if t.isalpha())


@pytest.mark.parametrize("lang", list(LANGS))
def test_stem_matches_nltk_on_the_pages_tokens(lang, page_tokens):
    from nltk.stem import SnowballStemmer

    ref = SnowballStemmer(LANGS[lang])
    words = page_tokens + INFLECTED[lang]
    assert len(page_tokens) > 300
    assert [port_stemmer.stem(w, lang) for w in words] == [ref.stem(w) for w in words]
    assert port_stemmer.stem_tokens(words, lang) == [ref.stem(w) for w in words]


def test_stem_matches_the_jax_package():
    from stract_tpu.tokenizer import stemmer as jax_stemmer

    for lang, words in INFLECTED.items():
        assert [port_stemmer.stem(w, lang) for w in words] == \
            [jax_stemmer.stem(w, lang) for w in words], lang


def test_languages_without_a_stemmer_keep_the_token():
    """Polish (and any code outside the table) stems to the token itself, by
    the table: there is no error to catch."""
    assert port_stemmer.stem("wyszukiwarki", "pl") == "wyszukiwarki"
    assert port_stemmer.stem_tokens(["miasta", "running"], "xx") == ["miasta", "running"]


def test_stem_without_nltk():
    """With nltk unimportable the port still stems (the port imports no nltk)."""
    code = ("import sys\nsys.modules['nltk'] = None\n"
            "from stract_tpu_torch.tokenizer.stemmer import stem, stem_tokens\n"
            "from stract_tpu_torch import snippet\n"
            "assert stem('running') == 'run', stem('running')\n"
            "assert stem_tokens(['connections', 'ponies']) == ['connect', 'poni']\n"
            "assert stem('häuser', 'de') == 'haus' and stem('chevaux', 'fr') == 'cheval'\n"
            "assert snippet._word_stem('running') == 'run'\n"
            "assert 'nltk' not in [m.split('.')[0] for m in sys.modules if sys.modules[m]]\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
