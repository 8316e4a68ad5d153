"""femto_tpu: a compressed-text indexing and search framework in JAX.

Capabilities of femto-dev/femto (FM-index construction + count/locate/
document/regex/approximate/Boolean queries), re-architected for an
accelerator: suffix sort and BWT as XLA sort/scan passes, rank/Occ as
batched segment-checkpoint lookups, queries as lockstep batched scans, and
multi-device scaling via jax.sharding meshes with collectives in place of
MPI pipes.
"""

from .alphabet import (
    ALPHA_SIZE,
    CHARACTER_OFFSET,
    PreparedText,
    prepare_documents,
)
from .fmindex import FMArrays, FMIndex, FMMeta, build_index
from .suffix import suffix_array, bwt_from_sa
from .search import (
    count,
    count_ranges,
    extract_context,
    extract_document,
    locate,
    locate_range,
    offsets_to_docs,
)

__version__ = "0.1.0"
