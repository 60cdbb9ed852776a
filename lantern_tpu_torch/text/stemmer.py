"""English stemming + stopwords (own copy of lantern_tpu/text/stemmer.py) —
parity with lantern_extras stemmers (X5).

The reference uses rust-stemmers (Snowball) via `text_to_stem_array` and
manages user stopword files in SHAREDIR (stemmers.rs:1-50). Here: a clean
Porter stemmer implementation (the Snowball English ancestor) plus the
classic English stopword list and user-stopword management.
"""

from __future__ import annotations

import os
import re

_V = "aeiou"

DEFAULT_STOPWORDS = frozenset(
    """a about above after again against all am an and any are aren't as at be
because been before being below between both but by can't cannot could
couldn't did didn't do does doesn't doing don't down during each few for from
further had hadn't has hasn't have haven't having he he'd he'll he's her here
here's hers herself him himself his how how's i i'd i'll i'm i've if in into
is isn't it it's its itself let's me more most mustn't my myself no nor not of
off on once only or other ought our ours ourselves out over own same shan't
she she'd she'll she's should shouldn't so some such than that that's the
their theirs them themselves then there there's these they they'd they'll
they're they've this those through to too under until up very was wasn't we
we'd we'll we're we've were weren't what what's when when's where where's
which while who who's whom why why's with won't would wouldn't you you'd
you'll you're you've your yours yourself yourselves""".split()
)


def _is_cons(word: str, i: int) -> bool:
    c = word[i]
    if c in _V:
        return False
    if c == "y":
        return i == 0 or not _is_cons(word, i - 1)
    return True


def _measure(stem: str) -> int:
    """Porter's m: number of VC sequences."""
    forms = ""
    for i in range(len(stem)):
        forms += "c" if _is_cons(stem, i) else "v"
    return len(re.findall("vc", forms))


def _has_vowel(stem: str) -> bool:
    return any(not _is_cons(stem, i) for i in range(len(stem)))


def _ends_double_cons(word: str) -> bool:
    return (
        len(word) >= 2
        and word[-1] == word[-2]
        and _is_cons(word, len(word) - 1)
    )


def _cvc(word: str) -> bool:
    if len(word) < 3:
        return False
    return (
        _is_cons(word, len(word) - 3)
        and not _is_cons(word, len(word) - 2)
        and _is_cons(word, len(word) - 1)
        and word[-1] not in "wxy"
    )


def porter_stem(word: str) -> str:
    """Porter stemming algorithm (Porter 1980), steps 1a-5b."""
    w = word.lower()
    if len(w) <= 2:
        return w

    # step 1a
    if w.endswith("sses"):
        w = w[:-2]
    elif w.endswith("ies"):
        w = w[:-2]
    elif w.endswith("ss"):
        pass
    elif w.endswith("s"):
        w = w[:-1]

    # step 1b
    if w.endswith("eed"):
        if _measure(w[:-3]) > 0:
            w = w[:-1]
    elif w.endswith("ed") and _has_vowel(w[:-2]):
        w = w[:-2]
        w = _step1b_fixup(w)
    elif w.endswith("ing") and _has_vowel(w[:-3]):
        w = w[:-3]
        w = _step1b_fixup(w)

    # step 1c
    if w.endswith("y") and _has_vowel(w[:-1]):
        w = w[:-1] + "i"

    # step 2
    for suf, rep in (
        ("ational", "ate"), ("tional", "tion"), ("enci", "ence"), ("anci", "ance"),
        ("izer", "ize"), ("abli", "able"), ("alli", "al"), ("entli", "ent"),
        ("eli", "e"), ("ousli", "ous"), ("ization", "ize"), ("ation", "ate"),
        ("ator", "ate"), ("alism", "al"), ("iveness", "ive"), ("fulness", "ful"),
        ("ousness", "ous"), ("aliti", "al"), ("iviti", "ive"), ("biliti", "ble"),
    ):
        if w.endswith(suf):
            if _measure(w[: -len(suf)]) > 0:
                w = w[: -len(suf)] + rep
            break

    # step 3
    for suf, rep in (
        ("icate", "ic"), ("ative", ""), ("alize", "al"), ("iciti", "ic"),
        ("ical", "ic"), ("ful", ""), ("ness", ""),
    ):
        if w.endswith(suf):
            if _measure(w[: -len(suf)]) > 0:
                w = w[: -len(suf)] + rep
            break

    # step 4
    for suf in (
        "al", "ance", "ence", "er", "ic", "able", "ible", "ant", "ement",
        "ment", "ent", "ou", "ism", "ate", "iti", "ous", "ive", "ize",
    ):
        if w.endswith(suf):
            stem = w[: -len(suf)]
            if _measure(stem) > 1:
                w = stem
            break
    else:
        if w.endswith("ion") and len(w) > 3 and w[-4] in "st" and _measure(w[:-3]) > 1:
            w = w[:-3]

    # step 5a
    if w.endswith("e"):
        stem = w[:-1]
        m = _measure(stem)
        if m > 1 or (m == 1 and not _cvc(stem)):
            w = stem
    # step 5b
    if _measure(w) > 1 and _ends_double_cons(w) and w.endswith("l"):
        w = w[:-1]
    return w


def _step1b_fixup(w: str) -> str:
    if w.endswith(("at", "bl", "iz")):
        return w + "e"
    if _ends_double_cons(w) and not w.endswith(("l", "s", "z")):
        return w[:-1]
    if _measure(w) == 1 and _cvc(w):
        return w + "e"
    return w


_TOKEN_RE = re.compile(r"[a-z0-9']+")


def text_to_stem_array(
    text: str,
    stopwords: frozenset | set | None = DEFAULT_STOPWORDS,
) -> list[str]:
    """Tokenize + stopword-filter + stem (text_to_stem_array SQL fn parity)."""
    stops = stopwords or frozenset()
    out = []
    for tok in _TOKEN_RE.findall(text.lower()):
        if tok in stops:
            continue
        tok = tok.strip("'")
        if not tok:  # apostrophe-only token — no empty-string terms
            continue
        out.append(porter_stem(tok))
    return out


# ---- user stopword management (stemmers.rs SHAREDIR files) ----

def _stopword_dir() -> str:
    d = os.environ.get(
        "LANTERN_TPU_SHAREDIR",
        os.path.join(os.path.expanduser("~"), ".lantern_tpu"),
    )
    os.makedirs(d, exist_ok=True)
    return d


def set_user_stopwords(name: str, words: list[str]):
    with open(os.path.join(_stopword_dir(), f"stopwords_{name}.txt"), "w") as f:
        f.write("\n".join(sorted(set(w.lower() for w in words))))


def get_user_stopwords(name: str) -> frozenset:
    path = os.path.join(_stopword_dir(), f"stopwords_{name}.txt")
    if not os.path.exists(path):
        return frozenset()
    with open(path) as f:
        return frozenset(line.strip() for line in f if line.strip())
