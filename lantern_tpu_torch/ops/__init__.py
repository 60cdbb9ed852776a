"""Distance functions and the port's hand-written kernels."""

from lantern_tpu_torch.ops.distance import (  # noqa: F401
    cos_dist,
    exact_search,
    hamming_dist,
    l2sq_dist,
    pack_bits,
    pairwise_dist,
    unpack_bits,
)
from lantern_tpu_torch.ops.gather_dists import (  # noqa: F401
    gather_dists,
    gather_dists_ref,
)
from lantern_tpu_torch.ops.hamming import (  # noqa: F401
    hamming_block,
    hamming_block_ref,
    hamming_exact_topk,
    hamming_scores,
    hamming_scores_ref,
)
from lantern_tpu_torch.ops.pq_decode import (  # noqa: F401
    codebook_bf16,
    pq_decode,
    pq_decode_ref,
)
