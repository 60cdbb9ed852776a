"""Full-text helpers beside the vector index: BM25, bloom filters and
Porter stemming (numpy only; own copies of lantern_tpu/text)."""

from lantern_tpu_torch.text.bloom import Bloom  # noqa: F401
from lantern_tpu_torch.text.bm25 import Bm25Index, create_bm25_table  # noqa: F401
from lantern_tpu_torch.text.stemmer import (  # noqa: F401
    DEFAULT_STOPWORDS,
    porter_stem,
    text_to_stem_array,
)
