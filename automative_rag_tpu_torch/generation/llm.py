"""Answer generation: LLM backends + the mode-aware generation pipeline.

Parity targets:
- ``LocalLLM.answer_query_with_mode_specific_params``
  (``src/core/query/llm/local_llm.py:405-492``): mode params → context build
  → prompt → generate → ``<think>`` tag stripping → fact check.
- confidence = ``min(100, avg_relevance*50 + validation_confidence*0.5)``
  (``src/core/query/tasks/inference_tasks.py:119``).

Backends:
- ``StubLLM`` — extractive answerer: quotes the highest-relevance sentences
  that share key terms with the query, each with its 【来源：DOC_X】 citation.
  Keeps the full pipeline functional (and honest about provenance) with no
  weights in the environment. It is the only backend of this package so far.
"""

from __future__ import annotations

import re
import time
from typing import Any, Dict, List, Optional, Protocol, Tuple

from ..config.mode_config import QueryMode, mode_config
from ..documents.schema import Document
from ..ingestion.metadata import find_query_entities
from ..utils.quality import METRIC_SYNONYMS, extract_key_terms, term_matches
from .context import documents_in_context_order, format_documents_with_relevance_scores
from .fact_check import SimpleFactChecker
from .prompts import build_prompt

_THINK_RE = re.compile(r"<think>.*?</think>", re.DOTALL)
# don't treat a decimal point inside a number (6.9秒, 3.0T) as a boundary
_SENTENCE_SPLIT = re.compile(r"(?<=[。！？!?])\s*|(?<=\.)(?!\d)\s*")
_NUMERAL = re.compile(r"\d")
_MARKER_RE = re.compile(r"【[^】]*】")
# metric-seeking question detection for the extractive value tie-break:
# extract_key_terms canonicalizes metric synonyms (能跑多远 → 续航里程), so
# matching any key term against this lexicon string flags a spec question
_METRIC_HINT = "，".join(sorted(
    set(METRIC_SYNONYMS.values())
    | {"续航里程", "电池容量", "马力", "扭矩", "综合油耗", "百公里加速",
       "最高时速", "轴距", "后备箱容积", "电耗", "容积", "车重", "价格"}))


class LLMBackend(Protocol):
    def generate(self, prompt: str, params: Dict[str, Any]) -> str: ...


class StubLLM:
    """Extractive answerer — no weights needed, citations always real."""

    name = "extractive-stub"

    def generate(self, prompt: str, params: Dict[str, Any]) -> str:
        # the context rides in params, so concurrent callers can share this
        # instance without one query answering from another's documents
        context: List[Tuple[str, Document, float]] = params["_stub_context"]
        question: str = params["_stub_question"]
        terms = extract_key_terms(question)
        # short CJK model names (汉, 唐) fall below extract_key_terms'
        # length floor, so a sibling doc sharing every OTHER term (e.g. a
        # trim code shared across models) ties with the queried model's
        # doc — the boundary-aware entity matcher restores the
        # discriminating term (EVAL r05 shared_code_split)
        for val in find_query_entities(question).values():
            for v in (val if isinstance(val, list) else [val]):
                if v and v not in terms:
                    terms.append(v)
        # spec questions want a VALUE: between sentences matching the same
        # number of query terms, one that carries a numeral beats opinion
        # prose ("CLTC续航715公里" over "续航表现不错") — on distractor-
        # heavy corpora the context mixes spec and review docs of the same
        # entity, and review sentences can tie on matched terms with a
        # higher retrieval score. Quote/debate questions are unaffected:
        # their key terms come from the opinion language itself, so
        # opinion sentences out-MATCH before this tie-break is consulted.
        wants_value = bool(_NUMERAL.search(question)) or any(
            term_matches(t, _METRIC_HINT) for t in terms)
        candidates: List[tuple] = []
        for order, (doc_id, doc, score) in enumerate(context):
            for sentence in _SENTENCE_SPLIT.split(doc.page_content):
                sentence = sentence.strip()
                if not sentence:
                    continue
                matched = sum(1 for t in terms if term_matches(t, sentence))
                if terms and matched == 0:
                    continue
                # ingested chunks open with the injected metadata header
                # (【brand:…】【year:2023】…) glued to the first sentence —
                # its digits must not make opinion prose read as a value
                has_value = 1 if (wants_value and _NUMERAL.search(
                    _MARKER_RE.sub("", sentence))) else 0
                candidates.append(
                    (matched, has_value, score, -order,
                     f"{sentence}【来源：{doc_id}】")
                )
        if not candidates:
            text = "根据提供文档，未找到具体的相关数据。"
        else:
            # most matched query terms first, then the value tie-break,
            # then retrieval relevance
            candidates.sort(key=lambda c: c[:4], reverse=True)
            top = candidates[:5]
            if wants_value:
                # shared-term near-duplicates (e.g. one trim code shared
                # across models) tie on every term except the queried
                # entity — keep only the best-matched tier so a sibling
                # model's value never rides into a value answer (EVAL r05
                # shared_code_split: cross_model_confusion was 0.5). Only
                # when that tier itself carries a value: a review sentence
                # can out-match the spec sentence without having one.
                best = top[0][0]
                tier = [c for c in top if c[0] == best]
                if any(c[1] for c in tier):
                    top = tier
            picked = [c[4] for c in top]
            text = "。".join(p.rstrip("。") for p in picked) + "。"
        return text


def load_llm(model_path: str = "", weight_bits: int = 0,
             kv_bits: int = 0) -> LLMBackend:
    """The extractive ``StubLLM`` when no checkpoint is configured. A
    checkpoint path raises: the Qwen2 decoder (with its flash-attention
    and w4a16 kernels) is not part of this package yet, and a configured
    model must never degrade silently to the stub."""
    if model_path:
        raise NotImplementedError(
            f"LLM_MODEL_PATH={model_path!r}: the Qwen2 decoder is not ported "
            "to automative_rag_tpu_torch yet (Qwen2 lands in a later slice); "
            "unset LLM_MODEL_PATH to answer with the extractive StubLLM")
    return StubLLM()


class AnswerGenerator:
    """Mode-aware answer pipeline over any LLM backend."""

    def __init__(self, llm: Optional[LLMBackend] = None):
        self.llm = llm or StubLLM()
        self.fact_checker = SimpleFactChecker()

    def answer(
        self,
        query: str,
        documents: List[Tuple[Document, float]],
        mode: QueryMode | str = QueryMode.FACTS,
    ) -> Dict[str, Any]:
        t0 = time.perf_counter()
        mode = QueryMode.parse(mode)
        llm_params = mode_config.get_llm_params(mode)
        ctx_params = mode_config.get_context_params(mode)

        context = format_documents_with_relevance_scores(
            documents, max_token_budget=ctx_params["max_context_tokens"]
        )
        ordered = documents_in_context_order(documents)
        prompt = build_prompt(mode, context, query)

        if isinstance(self.llm, StubLLM):
            llm_params = {**llm_params, "_stub_context": ordered,
                          "_stub_question": query}
        raw = self.llm.generate(prompt, llm_params)
        # extractive answers are document-grounded by construction — wrap
        # them in the evidence section marker for the complex modes so the
        # two-layer UI renders identically with or without an LLM
        if isinstance(self.llm, StubLLM) and raw and mode in (
            QueryMode.FEATURES, QueryMode.SCENARIOS
        ) and not raw.startswith(
            ("【实证分析】", "【策略推理】", "【文档支撑】", "【权衡分析】", "【场景推荐】")
        ):
            # the old any-【 guard mistook the 【brand:…】 metadata marker
            # (which every injected chunk quote starts with) for a section
            # marker, so extractive features/scenarios answers never got
            # their evidence section and the two-layer UI fell back flat
            raw = f"【实证分析】{raw}"
        return self._finalize(raw, documents, ordered, context, mode, ctx_params, t0)

    def _finalize(self, raw, documents, ordered, context, mode, ctx_params, t0):
        answer = _THINK_RE.sub("", raw).strip()

        check = self.fact_checker.simple_quality_check(answer, context)
        avg_rel = sum(s for _, s in documents) / len(documents) if documents else 0.0
        confidence = min(100.0, avg_rel * 50 + check["quality_score"] * 0.5)

        cited = set(re.findall(r"【来源：([^】]+)】", answer))
        # zh-output models routinely normalize to full-width punctuation:
        # 【来源：DOC_1，DOC_2】 must credit both sources
        cited_ids = {c.strip() for group in cited
                     for c in re.split(r"[,，、]", group)}
        sources = [
            {
                "doc_id": doc_id,
                "score": score,
                "metadata": doc.metadata,
                "id": doc.id,
                "cited": doc_id in cited_ids,
                # content preview for the UI metadata card (reference
                # metadata_display.py render_content_preview)
                "snippet": doc.page_content[:200],
            }
            for doc_id, doc, score in ordered
        ]

        # structured parse for list-shaped modes (UI debate/quotes renderers,
        # reference 智能查询.py two-layer display)
        structured: Dict[str, Any] = {}
        # two-layer sections (reference 智能查询.py:184-223 reads
        # analysis_structure["【实证分析】"] etc. — which the reference
        # service never actually produced; here the complex-mode prompts
        # request the markers and this parse delivers them)
        sections = re.split(
            r"(【(?:实证分析|策略推理|文档支撑|权衡分析|场景推荐)】)", answer)
        if len(sections) >= 3:
            layered: Dict[str, str] = {}
            for head, body in zip(sections[1::2], sections[2::2]):
                body = body.strip()
                if body:
                    layered[head] = body
            if layered:
                structured["sections"] = layered
        if mode == QueryMode.TRADEOFFS:
            structured.update({
                "pros": re.findall(r"优点[:：]?\s*(.+)", answer),
                "cons": re.findall(r"缺点[:：]?\s*(.+)", answer),
            })
        elif mode == QueryMode.DEBATE:
            structured.update(
                {"viewpoints": re.findall(r"观点[一二三四五\d]+[:：]?\s*(.+)", answer)})
        elif mode == QueryMode.QUOTES:
            structured.update({"quotes": re.findall(r"[“\"](.+?)[”\"]", answer)})

        return {
            "answer": answer,
            "structured": structured,
            "mode": mode.value,
            "confidence": confidence,
            "quality_check": check,
            "sources": sources,
            "cited_doc_ids": sorted(cited_ids),
            "context_tokens_budget": ctx_params["max_context_tokens"],
            "generation_time_s": time.perf_counter() - t0,
            "llm": getattr(self.llm, "name", "unknown"),
        }
