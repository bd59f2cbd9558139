"""Dataset class inventories (the ``DatasetSpec`` part of
``layoutdit_tpu/data/adapters.py``): the label names of PubLayNet,
DocLayNet and DocBank, which the prediction and serving tools print
beside each class id. The DocLayNet and DocBank converters wait for
ROADMAP queue 1 item 6."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    num_classes: int
    class_names: tuple[str, ...]


PUBLAYNET = DatasetSpec(
    "publaynet", 5, ("text", "title", "list", "table", "figure")
)

DOCLAYNET = DatasetSpec(
    "doclaynet", 11,
    ("Caption", "Footnote", "Formula", "List-item", "Page-footer",
     "Page-header", "Picture", "Section-header", "Table", "Text", "Title"),
)

DOCBANK = DatasetSpec(
    "docbank", 13,
    ("abstract", "author", "caption", "date", "equation", "figure",
     "footer", "list", "paragraph", "reference", "section", "table",
     "title"),
)

SPECS = {s.name: s for s in (PUBLAYNET, DOCLAYNET, DOCBANK)}
