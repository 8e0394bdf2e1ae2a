"""Automotive domain metadata extraction (bilingual zh/en).

Capability parity with the reference's ``MetadataExtractor``
(``src/core/ingestion/loaders/enhanced_transcript_processor.py:18-269``):
a manufacturer alias dictionary (Chinese + English names → canonical Chinese
brand), a model catalog carrying manufacturer/vehicleType/fuelType, and
regex patterns for model year, vehicle type, fuel type, transmission, plus
``author:``/``views:``/``source:`` fields injected by upstream loaders. The
dictionaries are re-authored (same real-world facts, independent catalog).
"""

from __future__ import annotations

import re
from typing import Any, Dict, Optional, Tuple

# alias (lowercased) → canonical brand name (Chinese, as the reference UI expects)
MANUFACTURER_ALIASES: Dict[str, str] = {
    # Chinese brands
    "吉利": "吉利", "geely": "吉利",
    "比亚迪": "比亚迪", "byd": "比亚迪",
    "长城": "长城", "哈弗": "长城", "haval": "长城", "great wall": "长城",
    "蔚来": "蔚来", "nio": "蔚来",
    "理想": "理想", "li auto": "理想", "lixiang": "理想",
    "小鹏": "小鹏", "xpeng": "小鹏",
    "奇瑞": "奇瑞", "chery": "奇瑞",
    "长安": "长安", "changan": "长安",
    "红旗": "红旗", "hongqi": "红旗",
    "五菱": "五菱", "wuling": "五菱",
    "零跑": "零跑", "leapmotor": "零跑",
    "问界": "问界", "aito": "问界",
    "极氪": "极氪", "zeekr": "极氪",
    # international brands
    "宝马": "宝马", "bmw": "宝马",
    "奔驰": "奔驰", "mercedes": "奔驰", "benz": "奔驰", "mercedes-benz": "奔驰",
    "奥迪": "奥迪", "audi": "奥迪",
    "特斯拉": "特斯拉", "tesla": "特斯拉",
    "丰田": "丰田", "toyota": "丰田",
    "本田": "本田", "honda": "本田",
    "大众": "大众", "volkswagen": "大众", "vw": "大众",
    "福特": "福特", "ford": "福特",
    "日产": "日产", "nissan": "日产",
    "现代": "现代", "hyundai": "现代",
    "起亚": "起亚", "kia": "起亚",
    "保时捷": "保时捷", "porsche": "保时捷",
    "沃尔沃": "沃尔沃", "volvo": "沃尔沃",
    "雷克萨斯": "雷克萨斯", "lexus": "雷克萨斯",
    "马自达": "马自达", "mazda": "马自达",
    "斯巴鲁": "斯巴鲁", "subaru": "斯巴鲁",
    "别克": "别克", "buick": "别克",
    "雪佛兰": "雪佛兰", "chevrolet": "雪佛兰",
    "凯迪拉克": "凯迪拉克", "cadillac": "凯迪拉克",
}

# model name → {manufacturer, vehicleType, fuelType}; vehicleType in
# {轿车, SUV, MPV}, fuelType in {汽油, 电动, 混动}
MODEL_CATALOG: Dict[str, Dict[str, str]] = {
    # 吉利
    "星越L": {"manufacturer": "吉利", "vehicleType": "SUV", "fuelType": "汽油"},
    "星越": {"manufacturer": "吉利", "vehicleType": "SUV", "fuelType": "汽油"},
    "缤越": {"manufacturer": "吉利", "vehicleType": "SUV", "fuelType": "汽油"},
    "博越": {"manufacturer": "吉利", "vehicleType": "SUV", "fuelType": "汽油"},
    "帝豪": {"manufacturer": "吉利", "vehicleType": "轿车", "fuelType": "汽油"},
    "几何A": {"manufacturer": "吉利", "vehicleType": "轿车", "fuelType": "电动"},
    "几何C": {"manufacturer": "吉利", "vehicleType": "SUV", "fuelType": "电动"},
    # 比亚迪
    "汉EV": {"manufacturer": "比亚迪", "vehicleType": "轿车", "fuelType": "电动"},
    "唐DM": {"manufacturer": "比亚迪", "vehicleType": "SUV", "fuelType": "混动"},
    "汉": {"manufacturer": "比亚迪", "vehicleType": "轿车", "fuelType": "汽油"},
    "唐": {"manufacturer": "比亚迪", "vehicleType": "SUV", "fuelType": "汽油"},
    "宋PLUS": {"manufacturer": "比亚迪", "vehicleType": "SUV", "fuelType": "混动"},
    "宋": {"manufacturer": "比亚迪", "vehicleType": "SUV", "fuelType": "汽油"},
    "秦PLUS": {"manufacturer": "比亚迪", "vehicleType": "轿车", "fuelType": "混动"},
    "秦": {"manufacturer": "比亚迪", "vehicleType": "轿车", "fuelType": "汽油"},
    "元PLUS": {"manufacturer": "比亚迪", "vehicleType": "SUV", "fuelType": "电动"},
    "海豹": {"manufacturer": "比亚迪", "vehicleType": "轿车", "fuelType": "电动"},
    "海豚": {"manufacturer": "比亚迪", "vehicleType": "轿车", "fuelType": "电动"},
    # 长城
    "哈弗H6": {"manufacturer": "长城", "vehicleType": "SUV", "fuelType": "汽油"},
    "坦克300": {"manufacturer": "长城", "vehicleType": "SUV", "fuelType": "汽油"},
    # 新势力
    "ES6": {"manufacturer": "蔚来", "vehicleType": "SUV", "fuelType": "电动"},
    "ES8": {"manufacturer": "蔚来", "vehicleType": "SUV", "fuelType": "电动"},
    "ET5": {"manufacturer": "蔚来", "vehicleType": "轿车", "fuelType": "电动"},
    "理想ONE": {"manufacturer": "理想", "vehicleType": "SUV", "fuelType": "混动"},
    "L9": {"manufacturer": "理想", "vehicleType": "SUV", "fuelType": "混动"},
    "L8": {"manufacturer": "理想", "vehicleType": "SUV", "fuelType": "混动"},
    "L7": {"manufacturer": "理想", "vehicleType": "SUV", "fuelType": "混动"},
    "P7": {"manufacturer": "小鹏", "vehicleType": "轿车", "fuelType": "电动"},
    "G9": {"manufacturer": "小鹏", "vehicleType": "SUV", "fuelType": "电动"},
    "G6": {"manufacturer": "小鹏", "vehicleType": "SUV", "fuelType": "电动"},
    # BMW
    "X5": {"manufacturer": "宝马", "vehicleType": "SUV", "fuelType": "汽油"},
    "X3": {"manufacturer": "宝马", "vehicleType": "SUV", "fuelType": "汽油"},
    "X1": {"manufacturer": "宝马", "vehicleType": "SUV", "fuelType": "汽油"},
    "3系": {"manufacturer": "宝马", "vehicleType": "轿车", "fuelType": "汽油"},
    "5系": {"manufacturer": "宝马", "vehicleType": "轿车", "fuelType": "汽油"},
    "7系": {"manufacturer": "宝马", "vehicleType": "轿车", "fuelType": "汽油"},
    "i3": {"manufacturer": "宝马", "vehicleType": "轿车", "fuelType": "电动"},
    "iX3": {"manufacturer": "宝马", "vehicleType": "SUV", "fuelType": "电动"},
    # Mercedes
    "C级": {"manufacturer": "奔驰", "vehicleType": "轿车", "fuelType": "汽油"},
    "E级": {"manufacturer": "奔驰", "vehicleType": "轿车", "fuelType": "汽油"},
    "S级": {"manufacturer": "奔驰", "vehicleType": "轿车", "fuelType": "汽油"},
    "GLC": {"manufacturer": "奔驰", "vehicleType": "SUV", "fuelType": "汽油"},
    "GLE": {"manufacturer": "奔驰", "vehicleType": "SUV", "fuelType": "汽油"},
    # Audi
    "A4L": {"manufacturer": "奥迪", "vehicleType": "轿车", "fuelType": "汽油"},
    "A6L": {"manufacturer": "奥迪", "vehicleType": "轿车", "fuelType": "汽油"},
    "Q5L": {"manufacturer": "奥迪", "vehicleType": "SUV", "fuelType": "汽油"},
    "Q7": {"manufacturer": "奥迪", "vehicleType": "SUV", "fuelType": "汽油"},
    # Tesla
    "Model 3": {"manufacturer": "特斯拉", "vehicleType": "轿车", "fuelType": "电动"},
    "Model Y": {"manufacturer": "特斯拉", "vehicleType": "SUV", "fuelType": "电动"},
    "Model S": {"manufacturer": "特斯拉", "vehicleType": "轿车", "fuelType": "电动"},
    "Model X": {"manufacturer": "特斯拉", "vehicleType": "SUV", "fuelType": "电动"},
    # Toyota / Honda / VW
    "凯美瑞": {"manufacturer": "丰田", "vehicleType": "轿车", "fuelType": "汽油"},
    "卡罗拉": {"manufacturer": "丰田", "vehicleType": "轿车", "fuelType": "汽油"},
    "汉兰达": {"manufacturer": "丰田", "vehicleType": "SUV", "fuelType": "汽油"},
    "RAV4": {"manufacturer": "丰田", "vehicleType": "SUV", "fuelType": "汽油"},
    "雅阁": {"manufacturer": "本田", "vehicleType": "轿车", "fuelType": "汽油"},
    "思域": {"manufacturer": "本田", "vehicleType": "轿车", "fuelType": "汽油"},
    "CR-V": {"manufacturer": "本田", "vehicleType": "SUV", "fuelType": "汽油"},
    "迈腾": {"manufacturer": "大众", "vehicleType": "轿车", "fuelType": "汽油"},
    "帕萨特": {"manufacturer": "大众", "vehicleType": "轿车", "fuelType": "汽油"},
    "途观L": {"manufacturer": "大众", "vehicleType": "SUV", "fuelType": "汽油"},
    "ID.4": {"manufacturer": "大众", "vehicleType": "SUV", "fuelType": "电动"},
}

_YEAR_RE = re.compile(r"(20[0-3][0-9])\s*款?|(19[89][0-9])\s*款?")
_TYPE_PATTERNS = (
    (re.compile(r"SUV|越野", re.IGNORECASE), "SUV"),
    (re.compile(r"MPV|商务车"), "MPV"),
    (re.compile(r"轿车|sedan", re.IGNORECASE), "轿车"),
    (re.compile(r"跑车|coupe|sports car", re.IGNORECASE), "跑车"),
)
_FUEL_PATTERNS = (
    (re.compile(r"纯电|电动|EV\b|electric", re.IGNORECASE), "电动"),
    (re.compile(r"混动|混合动力|hybrid|PHEV|DM-?i", re.IGNORECASE), "混动"),
    (re.compile(r"柴油|diesel", re.IGNORECASE), "柴油"),
    (re.compile(r"汽油|gasoline|petrol", re.IGNORECASE), "汽油"),
)
_TRANS_PATTERNS = (
    (re.compile(r"手动|manual|MT\b", re.IGNORECASE), "手动"),
    (re.compile(r"双离合|DCT", re.IGNORECASE), "双离合"),
    (re.compile(r"CVT", re.IGNORECASE), "CVT"),
    (re.compile(r"自动|automatic|AT\b", re.IGNORECASE), "自动"),
)
_FIELD_RES = {
    "authorName": re.compile(r"(?:author|作者|UP主)[:：]\s*([^\s,，。]+)"),
    "viewsCount": re.compile(r"(?:views|播放量?)[:：]\s*([\d,]+)"),
    "sourcePlatform": re.compile(r"(?:source|来源)[:：]\s*(youtube|bilibili|\S+)", re.IGNORECASE),
}


class MetadataExtractor:
    """Extract structured automotive fields from free text and optionally
    remove the matched spans (extract-and-remove pipeline, reference
    :184-269)."""

    def extract(self, text: str) -> Dict[str, Any]:
        fields: Dict[str, Any] = {}
        lowered = text.lower()

        # model first (implies manufacturer/type/fuel); longest match wins.
        # Boundary-aware like the query side (_find_name): a naive substring
        # tags 唐山/X50/G63 docs with 唐/X5/G6 — wrong metadata poisons the
        # payload filters for every query over those fields
        for model in sorted(MODEL_CATALOG, key=len, reverse=True):
            if _find_name(text, lowered, model):
                info = MODEL_CATALOG[model]
                fields["model"] = model
                fields["manufacturer"] = info["manufacturer"]
                fields.setdefault("vehicleType", info["vehicleType"])
                fields.setdefault("fuelType", info["fuelType"])
                break

        if "manufacturer" not in fields:
            for alias in sorted(MANUFACTURER_ALIASES, key=len, reverse=True):
                if _find_name(text, lowered, alias):
                    fields["manufacturer"] = MANUFACTURER_ALIASES[alias]
                    break

        year_match = _YEAR_RE.search(text)
        if year_match:
            fields["modelYear"] = int(year_match.group(1) or year_match.group(2))

        # extract author/views/source fields first and strip their spans so
        # e.g. "source: manual" can't false-match the manual-transmission
        # pattern below
        stripped = text
        for key, pattern in _FIELD_RES.items():
            match = pattern.search(stripped)
            if match:
                fields[key] = match.group(1)
                stripped = pattern.sub(" ", stripped)

        for patterns, key in (
            (_TYPE_PATTERNS, "vehicleType"),
            (_FUEL_PATTERNS, "fuelType"),
            (_TRANS_PATTERNS, "transmission"),
        ):
            if key not in fields:
                for pattern, value in patterns:
                    if pattern.search(stripped):
                        fields[key] = value
                        break
        if "viewsCount" in fields:
            try:
                fields["viewsCount"] = int(str(fields["viewsCount"]).replace(",", ""))
            except ValueError:
                del fields["viewsCount"]

        return fields

    def extract_and_remove(self, text: str) -> Tuple[Dict[str, Any], str]:
        """Extract fields and strip the ``field: value`` spans so the
        remaining original text isn't duplicated in the chunk body."""
        fields = self.extract(text)
        remaining = text
        for pattern in _FIELD_RES.values():
            remaining = pattern.sub("", remaining)
        remaining = re.sub(r"\s{2,}", " ", remaining).strip()
        return fields, remaining

    def vehicle_detected(self, fields: Dict[str, Any]) -> bool:
        return bool(fields.get("manufacturer") or fields.get("model"))


_ALNUM_RE = re.compile(r"[0-9a-zA-Z]")
_CJK_RE = re.compile(r"[一-鿿]")
#: boundary cues that legitimize a single-CJK-char model match (汉, 唐):
#: possessives, conjunctions, whitespace, punctuation, "款" — anything that
#: ends the word. Without one, 唐 inside 唐山 would false-match.
_SINGLE_CHAR_OK = set("的和与对比款版年 \t，。、？！：;；()（）")

_METRIC_STARTERS: Optional[tuple] = None


def _metric_starters() -> tuple:
    """Metric phrases (canonical + synonyms, utils/quality.py lexicon) that
    can directly follow a single-CJK model name: “汉充一次电能跑多远”,
    “唐极速能到多少” are model mentions even without a particle, while
    “唐山” stays blocked (山 starts no metric phrase). Longest-first."""
    global _METRIC_STARTERS
    if _METRIC_STARTERS is None:
        from ..utils.quality import METRIC_SYNONYMS

        terms = set(METRIC_SYNONYMS) | set(METRIC_SYNONYMS.values())
        _METRIC_STARTERS = tuple(sorted(terms, key=len, reverse=True))
    return _METRIC_STARTERS


def _name_matches_at(text: str, lowered: str, name: str, start: int) -> bool:
    """Boundary-aware catalog-name match at ``start`` in ``text``.

    Alphanumeric name edges must not continue into more alphanumerics
    ("G6" must not match inside "G63"; "X5" not inside "X50"). Single-CJK-
    char names additionally require a word-ending cue after the match
    (“唐的…” yes, “唐山…” no) — one CJK char alone is too ambiguous."""
    end = start + len(name)
    if name and _ALNUM_RE.match(name[0]):
        if start > 0 and _ALNUM_RE.match(text[start - 1]):
            return False
    if name and _ALNUM_RE.match(name[-1]):
        if end < len(text) and _ALNUM_RE.match(text[end]):
            return False
    if len(name) == 1 and _CJK_RE.match(name):
        if (
            end < len(text)
            and text[end] not in _SINGLE_CHAR_OK
            and not text[end:].startswith(_metric_starters())
        ):
            return False
    return True


def _find_name(text: str, lowered: str, name: str) -> bool:
    target = name.lower()
    start = lowered.find(target)
    while start >= 0:
        if _name_matches_at(text, lowered, name, start):
            return True
        start = lowered.find(target, start + 1)
    return False


def find_query_entities(query: str) -> Dict[str, Any]:
    """Detect the filterable model/manufacturer a query names — the ONE
    shared matcher for query-side entity detection (used by the retrieval
    engine's entity-guided expansion and the /query/analyze assistant, so
    detection always agrees with the catalogs the payload index is built
    from). Case-insensitive, longest-name-first, boundary-aware."""
    lowered = query.lower()
    out: Dict[str, Any] = {}
    for model in sorted(MODEL_CATALOG, key=len, reverse=True):
        if _find_name(query, lowered, model):
            out["model"] = model
            out["manufacturer"] = MODEL_CATALOG[model]["manufacturer"]
            return out
    for alias in sorted(MANUFACTURER_ALIASES, key=len, reverse=True):
        if _find_name(query, lowered, alias):
            out["manufacturer"] = MANUFACTURER_ALIASES[alias]
            return out
    return out


