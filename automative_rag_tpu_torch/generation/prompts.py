"""Anti-hallucination prompt templates with mandatory sentence-level
citations.

Parity target: reference ``local_llm.py:301-403`` — a strict base template
requiring 【来源：DOC_X】 after every factual sentence, with mode-specific
variants for facts / features / quotes (other modes fall back to facts).
The wording is re-authored but preserves the contract: evidence-only
answers, no guessed numbers, Chinese output, per-sentence citations.
"""

from __future__ import annotations

from ..config.mode_config import QueryMode

CITATION_MARK = "【来源："  # citation prefix, e.g. 【来源：DOC_1】

_CITATION_RULES = """SENTENCE-LEVEL CITATIONS (MANDATORY):
- Every sentence stating a fact MUST end with 【来源：DOC_X】.
- Combine multiple sources as 【来源：DOC_1, DOC_2】.
- Example: "百公里加速时间为6.9秒【来源：DOC_1】。"
"""

_BASE_RULES = """CRITICAL ACCURACY RULES:
1. Use ONLY information explicitly present in the documents below.
2. If the documents do not contain the requested data, answer
   "根据提供文档，未找到具体的[参数]数据" — never estimate or guess.
3. Never invent numerical values; every number must come from a document.
4. Prefer documents with higher relevance indicators (🔥 > ⭐ > 📄).
"""

_TEMPLATES = {
    QueryMode.FACTS: (
        "You are an automotive specifications expert held to strict accuracy.\n\n"
        + _BASE_RULES + "\n" + _CITATION_RULES +
        "\nDocument Content:\n{context}\n\nQuestion:\n{question}\n\n"
        "IMPORTANT: Respond in Chinese; cite 【来源：DOC_X】 for every fact."
    ),
    QueryMode.FEATURES: (
        "You are an automotive product analyst. Ground every claim in the "
        "documents; clearly separate evidence from your own analysis.\n\n"
        + _BASE_RULES + "\n" + _CITATION_RULES +
        "\nDocument Content:\n{context}\n\nFeature Question:\n{question}\n\n"
        "IMPORTANT: Respond in Chinese. Structure as TWO layers (the UI "
        "renders them separately): a section headed 【实证分析】 containing "
        "only document-grounded facts with 【来源：DOC_X】 citations, then a "
        "section headed 【策略推理】 containing your own analysis (clearly "
        "marked reasoning, no invented numbers)."
    ),
    QueryMode.TRADEOFFS: (
        "You are an automotive advisor producing a balanced pros/cons "
        "analysis. Every pro and every con must trace to a document.\n\n"
        + _BASE_RULES + "\n" + _CITATION_RULES +
        "\nDocument Content:\n{context}\n\nTrade-off Question:\n{question}\n\n"
        "IMPORTANT: Respond in Chinese as 优点/缺点 lists with citations. "
        "Open with a 【文档支撑】 section (cited facts only), then a "
        "【权衡分析】 section with the pros/cons lists."
    ),
    QueryMode.SCENARIOS: (
        "You are an automotive consultant evaluating fit for a usage "
        "scenario. Recommend only what the documents support.\n\n"
        + _BASE_RULES + "\n" + _CITATION_RULES +
        "\nDocument Content:\n{context}\n\nScenario Question:\n{question}\n\n"
        "IMPORTANT: Respond in Chinese with citations for every factual "
        "claim. Structure as a 【实证分析】 section (document facts) followed "
        "by a 【场景推荐】 section (your scenario-fit reasoning)."
    ),
    QueryMode.DEBATE: (
        "You are moderating a multi-perspective debate. Present distinct "
        "viewpoints, each grounded in cited document evidence.\n\n"
        + _BASE_RULES + "\n" + _CITATION_RULES +
        "\nDocument Content:\n{context}\n\nDebate Topic:\n{question}\n\n"
        "IMPORTANT: Respond in Chinese as 观点一/观点二/... with citations."
    ),
    QueryMode.QUOTES: (
        "You are extracting exact quotations. Copy quotes verbatim from the "
        "documents; fabricating or altering a quote is forbidden.\n\n"
        + _BASE_RULES + "\n" + _CITATION_RULES +
        "\nDocument Content:\n{context}\n\nQuote Topic:\n{question}\n\n"
        "IMPORTANT: Output only real quotes, each with its 【来源：DOC_X】."
    ),
}


def build_prompt(mode, context: str, question: str) -> str:
    template = _TEMPLATES.get(QueryMode.parse(mode), _TEMPLATES[QueryMode.FACTS])
    return template.format(context=context, question=question)


