from .uint_coder import uint_encode  # noqa: F401
from .huffman import create_huffman_depths, depths_to_bits  # noqa: F401
from .cluster import cluster_histograms  # noqa: F401
from .entropy_write import (  # noqa: F401
    EntropyCode,
    build_entropy_code,
    write_entropy_code,
    write_tokens,
)
