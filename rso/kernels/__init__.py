from rso.kernels.distance import hamming_matrix_jnp, sad_matrix_jnp
from rso.kernels.cost_volume import WindowedSearchResult, windowed_sad_search

__all__ = [
    "hamming_matrix_jnp",
    "sad_matrix_jnp",
    "WindowedSearchResult",
    "windowed_sad_search",
]
