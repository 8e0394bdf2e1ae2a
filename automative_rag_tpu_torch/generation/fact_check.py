"""Post-generation sanity checks on LLM answers.

Parity target: reference ``SimpleFactChecker``
(``src/core/query/llm/local_llm.py:120-182``): plausibility ranges for
acceleration/top speed, and an answer-numbers-appear-in-context check.
Heavy plausibility logic is shared with ``utils.quality``.
"""

from __future__ import annotations

import re
from typing import Any, Dict

from ..utils import quality


class SimpleFactChecker:
    def simple_quality_check(self, answer: str, context: str) -> Dict[str, Any]:
        warnings = quality.check_numerical_specs_realistic(answer)

        numbers = re.findall(r"\d+(?:\.\d+)?", answer)
        unsupported = [n for n in numbers if n not in context]
        if len(unsupported) > 3:
            warnings.append("答案中包含较多文档中未提及的数字")

        score = max(0, 100 - len(warnings) * 20)
        return {
            "warnings": warnings,
            "quality_score": score,
            "has_issues": bool(warnings),
            "recommendation": "review_answer" if len(warnings) > 1 else "acceptable",
        }
