"""Automotive fact-check / quality library.

Parity target: reference ``src/utils/quality_utils.py`` — key-term
extraction, numerical-data detection, garbled-content detection,
plausibility ranges for acceleration/speed/power, document-level and
answer-level fact checking, and a user-facing warning formatter.
"""

from __future__ import annotations

import re
from typing import List

# ------------------------------------------------------------- extraction

_STOPWORDS = {
    "的", "了", "是", "在", "有", "和", "与", "或", "怎么样", "如何", "什么",
    "the", "a", "an", "is", "are", "of", "for", "to", "and", "or", "what",
    "how", "does", "do",
}


# interrogative/aux fragments that glue onto CJK runs ("X的百公里加速是多少")
_CJK_NOISE = re.compile(
    r"是多少|多少钱|怎么样|怎样|如何|什么|哪个|哪些|几秒|的话|请问|多少"
)
_CJK_SPLIT = re.compile(r"的|了|吗|呢")

_JIEBA = None


def _jieba():
    """jieba segmenter, lazily initialized (the reference also uses jieba
    for keyword analysis, enhanced_transcript_processor.py:2-3)."""
    global _JIEBA
    if _JIEBA is None:
        try:
            import jieba

            jieba.setLogLevel(60)
            jieba.initialize()
            _JIEBA = jieba
        except Exception:
            _JIEBA = False
    return _JIEBA or None


#: automotive metric synonym lexicon (domain dictionary, the same design
#: as the ingestion metadata dictionaries — reference
#: enhanced_transcript_processor.py keeps its own domain tables): maps
#: colloquial phrasings onto the canonical spec term so paraphrased
#: questions ("能跑多远", "零百", "极速") still match spec-sheet sentences.
METRIC_SYNONYMS = {
    "零百": "百公里加速", "加速时间": "百公里加速", "百公里提速": "百公里加速",
    "加速成绩": "百公里加速", "提速": "百公里加速",
    "极速": "最高时速", "最快能开多快": "最高时速", "最高速度": "最高时速",
    "功率": "马力", "动力多强": "马力", "多少匹": "马力",
    "能跑多远": "续航里程", "续航": "续航里程", "跑多远": "续航里程",
    "充一次电能跑": "续航里程",
    "轴距多长": "轴距", "车身轴距": "轴距",
    "油耗": "综合油耗", "耗油": "综合油耗", "费油": "综合油耗",
    "后备箱多大": "后备箱容积", "尾箱容积": "后备箱容积",
    # English metric phrasings (the reference is bilingual — its UI and
    # prompts handle zh/en queries; EVAL r05 english split): ASCII keys
    # match case-insensitively in the expanders. The appended CANONICAL zh
    # spec term is the lexical bridge from an English question to the
    # zh spec-sheet sentence — without it both retrieval arms see zero
    # token overlap beyond the model name.
    "0 to 100": "百公里加速", "0-100": "百公里加速",
    "acceleration": "百公里加速",
    "top speed": "最高时速", "fastest": "最高时速",
    "horsepower": "马力", "power output": "马力",
    "driving range": "续航里程", "battery range": "续航里程",
    "on a charge": "续航里程", "how far": "续航里程",
    "wheelbase": "轴距",
    "fuel consumption": "综合油耗", "fuel economy": "综合油耗",
    "trunk capacity": "后备箱容积", "boot space": "后备箱容积",
}


def _syn_hit(syn: str, query: str, query_lower: str) -> bool:
    return syn in query or (syn.isascii() and syn in query_lower)


def expand_metric_terms(query: str, terms: List[str]) -> List[str]:
    """Append the canonical metric term when the query uses a synonym
    (matched against the raw query: segmentation may split phrases like
    能跑多远)."""
    out = list(terms)
    query_lower = query.lower()
    for syn, canonical in METRIC_SYNONYMS.items():
        if _syn_hit(syn, query, query_lower) and canonical not in out:
            out.append(canonical)
    return out


def expand_query_synonyms(query: str) -> str:
    """Retrieval-side query expansion: append the canonical spec term for
    every colloquial metric synonym in the query (功率→马力, 充一次电能跑→
    续航里程, 极速→最高时速 …). Colloquial questions share no surface
    tokens with spec-sheet sentences, so on distractor-heavy corpora the
    entity's review/comparison docs crowd the fact doc out of the
    candidate set (EVAL --hard paraphrase split); the appended canonical
    term restores the lexical bridge for BOTH retrieval arms and the
    reranker. Identity when the query already speaks spec-sheet."""
    extra, seen = [], set()
    query_lower = query.lower()
    for syn, canonical in METRIC_SYNONYMS.items():
        if (_syn_hit(syn, query, query_lower) and canonical not in query
                and canonical not in seen):
            seen.add(canonical)
            extra.append(canonical)
    return query + " " + " ".join(extra) if extra else query


def extract_key_terms(query: str) -> List[str]:
    """Key terms from a query: jieba-segmented CJK words when available
    (regex CJK runs otherwise), latin words, numbers; stopwords and
    interrogative fragments stripped. Metric synonyms append their
    canonical spec term (METRIC_SYNONYMS) so paraphrases match."""
    cleaned = _CJK_SPLIT.sub(" ", _CJK_NOISE.sub(" ", query))
    segmenter = _jieba()
    if segmenter is not None:
        tokens: List[str] = []
        for piece in re.findall(r"[一-鿿]+|[a-zA-Z][a-zA-Z0-9-]*|\d+(?:\.\d+)?", cleaned):
            if re.fullmatch(r"[一-鿿]+", piece) and len(piece) > 2:
                tokens.extend(segmenter.cut(piece, cut_all=False))
            else:
                tokens.append(piece)
    else:
        tokens = re.findall(r"[一-鿿]+|[a-zA-Z][a-zA-Z0-9-]*|\d+(?:\.\d+)?", cleaned)
    terms = [t for t in tokens if t.lower() not in _STOPWORDS and len(t) > 1]
    return expand_metric_terms(query, terms)


def term_matches(term: str, text: str) -> bool:
    """Does a key term occur in the text? Exact substring for latin/numbers;
    CJK runs (which are unsegmented multi-word phrases like 特斯拉加速) match
    when most of their character bigrams appear — '特斯拉...加速' counts."""
    lowered = text.lower()
    term_l = term.lower()
    if term_l in lowered:
        return True
    if not re.fullmatch(r"[一-鿿]{3,}", term):
        return False
    bigrams = [term[i : i + 2] for i in range(len(term) - 1)]
    hits = sum(1 for b in bigrams if b in text)
    return hits >= max(1, int(0.6 * len(bigrams)))


# ----------------------------------------------------------- plausibility

# (pattern, lo, hi, warning template) — physically plausible ranges
_ACC_RE = re.compile(r"(\d+(?:\.\d+)?)\s*秒[^。]{0,16}?(?:百公里|零百|0-100)|(?:百公里|零百|0-100)[^。]{0,16}?(\d+(?:\.\d+)?)\s*秒")


def check_acceleration_claims(text: str) -> List[str]:
    warnings = []
    for match in _ACC_RE.finditer(text):
        value = match.group(1) or match.group(2)
        try:
            seconds = float(value)
        except (TypeError, ValueError):
            continue
        if seconds < 1.5 or seconds > 25:
            warnings.append(f"加速时间 {seconds} 秒超出合理范围 (1.5-25秒)")
    return warnings


_SPEC_RANGES = (
    (re.compile(r"(?:最高时速|极速)[^。]{0,12}?(\d{2,4})"), 50, 500, "最高时速 {v} km/h 超出合理范围"),
    (re.compile(r"(\d{2,5})\s*(?:马力|匹)"), 20, 2500, "马力 {v} 超出合理范围"),
    (re.compile(r"(?:功率)[^。]{0,10}?(\d{2,4})\s*(?:kw|千瓦)", re.IGNORECASE), 10, 1500, "功率 {v} kW 超出合理范围"),
    (re.compile(r"(?:油耗)[^。]{0,12}?(\d{1,2}(?:\.\d+)?)\s*(?:L|升)"), 1, 35, "油耗 {v} L 超出合理范围"),
    (re.compile(r"(?:续航)[^。]{0,12}?(\d{2,5})\s*(?:km|公里)"), 50, 2500, "续航 {v} km 超出合理范围"),
)


def check_numerical_specs_realistic(text: str) -> List[str]:
    warnings = list(check_acceleration_claims(text))
    for pattern, lo, hi, template in _SPEC_RANGES:
        for match in pattern.finditer(text):
            try:
                value = float(match.group(1))
            except ValueError:
                continue
            if value < lo or value > hi:
                warnings.append(template.format(v=match.group(1)))
    return warnings
