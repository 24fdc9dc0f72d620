"""Facial-caption marker processing (host-side, pure Python).

A copy of the JAX package's conditioning/markers.py, kept here so that the
port imports nothing of that package. It reimplements the reference caption
state machine (reference functions.py:14-109), quirks included:
  - remove_duplicate_keywords re-joins word/punct tokens with single spaces,
    leaving doubled spaces where a duplicate keyword was blanked out;
  - a feature word that never matches in the caption deletes that feature's
    mask entries from the (mutated) parsing-mask dict;
  - when two markers share one clause, extracting the first clause removes the
    second marker with it, and that region silently drops from the output.
"""
from __future__ import annotations

import re
from typing import Dict, List, Tuple

FACIAL_KEYWORDS = ("face", "ears", "eyes", "nose", "mouth")

# region-mask key -> caption keyword, in the reference's fixed priority order
REGION_TO_KEYWORD = {
    "Face": "face",
    "Left_Ear": "ears",
    "Right_Ear": "ears",
    "Left_Eye": "eyes",
    "Right_Eye": "eyes",
    "Nose": "nose",
    "Upper_Lip": "mouth",
    "Lower_Lip": "mouth",
}
REGION_KEY_ORDER = ("Face", "Left_Ear", "Right_Ear", "Left_Eye", "Right_Eye",
                    "Nose", "Upper_Lip", "Lower_Lip")

FACIAL_MARKER = "<|facial|>"
IMAGE_MARKER = "<|image|>"
CLAUSE_BOUNDARIES = (",", ".", ";")

_WORD_RE = re.compile(r"\b\w+\b|[.,;!?]")


def remove_duplicate_keywords(text: str,
                              keywords=FACIAL_KEYWORDS) -> str:
    """Blank out every occurrence of each keyword after its first."""
    tokens = _WORD_RE.findall(text)
    for keyword in keywords:
        seen = 0
        for i, tok in enumerate(tokens):
            if tok.lower() == keyword.lower():
                seen += 1
                if seen > 1:
                    tokens[i] = ""
    return " ".join(tokens)


def process_text_with_markers(text: str,
                              parsing_mask_list: Dict) -> Tuple[str, Dict]:
    """Insert `<|facial|>` markers after each region keyword's first mention
    and reorder the caption into one clause per region.

    `parsing_mask_list` (region-name -> mask) is mutated: entries whose
    keyword never appears in the caption are removed, so the surviving dict
    aligns 1:1 with the markers in the returned caption.
    """
    text = remove_duplicate_keywords(text)

    features: List[str] = []
    markers: List[str] = []
    for region in REGION_KEY_ORDER:
        if region in parsing_mask_list:
            kw = REGION_TO_KEYWORD[region]
            if kw not in features:
                features.append(kw)
                markers.append(f"<|{kw}|>")

    marked = text
    for feature, marker in zip(reversed(features), reversed(markers)):
        new = re.sub(rf"\b{feature}\b", f"{feature} {marker}", marked, count=1)
        if new == marked:
            # keyword absent from caption -> drop its region masks
            for region, kw in REGION_TO_KEYWORD.items():
                if kw == feature and region in parsing_mask_list:
                    del parsing_mask_list[region]
        marked = new
    marked = marked.replace("\n", "")

    ordered: List[str] = []
    for marker in markers:
        start = marked.find(marker)
        end = start + len(marker)
        while start > 0 and marked[start - 1] not in CLAUSE_BOUNDARIES:
            start -= 1
        while end < len(marked) and marked[end] not in CLAUSE_BOUNDARIES:
            end += 1
        clause = marked[start:end].strip()
        if clause:
            ordered.append(clause + ",")
            marked = marked[:start] + marked[end:]
        # empty clause (marker already consumed by an earlier clause): drop it

    result = " ".join(ordered)
    for kw in FACIAL_KEYWORDS:
        result = result.replace(f"<|{kw}|>", FACIAL_MARKER)
    return result, parsing_mask_list
