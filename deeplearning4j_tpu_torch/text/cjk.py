"""CJK tokenizer packs (Chinese / Japanese / Korean).

Parity: DL4J `deeplearning4j-nlp-{chinese,japanese,korean}/` — which wrap
external morphological analyzers (ansj, kuromoji, the Korean twitter
tokenizer). Those dictionaries cannot ship here (zero egress, and the
reference itself treats them as external artifacts); the port's
equivalents are self-contained segmenters with the same factory interface:

- script-aware run splitting (han / hiragana / katakana / hangul / latin /
  digits each form separate runs);
- optional user LEXICON with greedy longest-match segmentation inside han
  runs (how dictionary segmenters behave on in-vocabulary text);
- han text without a lexicon falls back to unigram+bigram emission (the
  standard dictionary-free CJK IR baseline);
- Korean particle stripping for the most common postpositions.

Factories satisfy the same `tokenize(text) -> List[str]` contract as
tokenization.DefaultTokenizerFactory, so every vectorizer/embedding
pipeline accepts them unchanged.
"""
from __future__ import annotations

from typing import Iterable, List, Optional


def _script(ch: str) -> str:
    o = ord(ch)
    if 0x4E00 <= o <= 0x9FFF or 0x3400 <= o <= 0x4DBF:
        return "han"
    if 0x3040 <= o <= 0x309F:
        return "hiragana"
    if 0x30A0 <= o <= 0x30FF or o == 0x30FC:
        return "katakana"
    if 0xAC00 <= o <= 0xD7AF:
        return "hangul"
    if ch.isdigit():
        return "digit"
    if ch.isalpha():
        return "latin"
    if ch.isspace():
        return "space"
    return "other"


def _runs(text: str):
    """Yield (script, run) with consecutive same-script chars grouped."""
    cur, cur_script = [], None
    for ch in text:
        s = _script(ch)
        if s != cur_script and cur:
            yield cur_script, "".join(cur)
            cur = []
        cur_script = s
        cur.append(ch)
    if cur:
        yield cur_script, "".join(cur)


def _greedy_lexicon_segment(run: str, lexicon, max_len: int) -> List[str]:
    out = []
    i = 0
    n = len(run)
    while i < n:
        match = None
        for L in range(min(max_len, n - i), 1, -1):
            if run[i:i + L] in lexicon:
                match = run[i:i + L]
                break
        if match:
            out.append(match)
            i += len(match)
        else:
            out.append(run[i])
            i += 1
    return out


class ChineseTokenizerFactory:
    """Han segmentation: lexicon longest-match when given, else
    unigram+bigram emission; latin/digit runs pass through whole
    (deeplearning4j-nlp-chinese's ChineseTokenizer role)."""

    def __init__(self, lexicon: Optional[Iterable[str]] = None,
                 emit_bigrams: bool = True, preprocessor=None):
        self.lexicon = frozenset(lexicon or ())
        self.max_word = max((len(w) for w in self.lexicon), default=1)
        self.emit_bigrams = emit_bigrams
        self.preprocessor = preprocessor

    def tokenize(self, text: str) -> List[str]:
        toks: List[str] = []
        for script, run in _runs(text):
            if script in ("space", "other"):
                continue
            if script == "han":
                if self.lexicon:
                    toks.extend(_greedy_lexicon_segment(
                        run, self.lexicon, self.max_word))
                else:
                    toks.extend(run)            # unigrams
                    if self.emit_bigrams:
                        toks.extend(run[i:i + 2]
                                    for i in range(len(run) - 1))
            else:
                toks.append(run)
        if self.preprocessor is not None:
            toks = [self.preprocessor.pre_process(t) for t in toks]
        return [t for t in toks if t]

    create = tokenize


class JapaneseTokenizerFactory:
    """Script-boundary segmentation (kanji/hiragana/katakana/latin runs
    split like a coarse morphological analyzer; kuromoji's role in
    deeplearning4j-nlp-japanese). Hiragana runs are kept whole (mostly
    particles/inflections); kanji runs segment via the optional lexicon
    like the Chinese factory."""

    def __init__(self, lexicon: Optional[Iterable[str]] = None,
                 preprocessor=None):
        self.lexicon = frozenset(lexicon or ())
        self.max_word = max((len(w) for w in self.lexicon), default=1)
        self.preprocessor = preprocessor

    def tokenize(self, text: str) -> List[str]:
        toks: List[str] = []
        for script, run in _runs(text):
            if script in ("space", "other"):
                continue
            if script == "han" and self.lexicon:
                toks.extend(_greedy_lexicon_segment(
                    run, self.lexicon, self.max_word))
            elif script == "han" and len(run) > 2:
                toks.extend(run[i:i + 2] for i in range(0, len(run), 2))
            else:
                toks.append(run)
        if self.preprocessor is not None:
            toks = [self.preprocessor.pre_process(t) for t in toks]
        return [t for t in toks if t]

    create = tokenize


# the most frequent Korean postpositional particles (josa); stripping them
# merges inflected forms of the same noun, the role the twitter-korean
# tokenizer's stemming plays in deeplearning4j-nlp-korean
_KO_PARTICLES = ("은", "는", "이", "가", "을", "를", "의", "에", "에서",
                 "으로", "로", "와", "과", "도", "만", "까지", "부터",
                 "에게", "한테", "처럼")


class KoreanTokenizerFactory:
    """Whitespace/script tokenization with particle handling. Without a
    morphological dictionary a bare noun ending in a particle syllable is
    indistinguishable from noun+particle (고양이 'cat' ends in the
    subject-particle syllable 이), so stripping single-syllable particles
    emits BOTH surface and stripped forms — 고양이 and 고양이가 then share
    the token 고양이, which is the form merging the feature exists for.
    Multi-syllable particles (에서, 으로...) are unambiguous enough to
    strip outright."""

    def __init__(self, strip_particles: bool = True, preprocessor=None):
        self.strip_particles = strip_particles
        self.preprocessor = preprocessor

    def _hangul_tokens(self, run: str) -> List[str]:
        if not self.strip_particles or len(run) < 2:
            return [run]
        for p in sorted(_KO_PARTICLES, key=len, reverse=True):
            if run.endswith(p) and len(run) > len(p):
                stem = run[:-len(p)]
                if len(p) >= 2:
                    return [stem]
                return [run, stem]      # ambiguous: keep both forms
        return [run]

    def tokenize(self, text: str) -> List[str]:
        toks: List[str] = []
        for script, run in _runs(text):
            if script in ("space", "other"):
                continue
            if script == "hangul":
                toks.extend(self._hangul_tokens(run))
            else:
                toks.append(run)
        if self.preprocessor is not None:
            toks = [self.preprocessor.pre_process(t) for t in toks]
        return [t for t in toks if t]

    create = tokenize
