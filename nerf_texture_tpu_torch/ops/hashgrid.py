"""Per-corner hash grid (port of ``nerf_texture_tpu/ops/hashgrid.py``).

Only the spatial-hash primes are ported so far; the packed encoder
(``hashgrid_packed.py``) hashes with them.  The per-corner encoder itself
waits for the NGP background grid."""

# Primes of the Instant-NGP spatial hash (prime[0] = 1 keeps the first
# axis coherent in memory; gridencoder/src/gridencoder.cu:36-51).
_HASH_PRIMES = (1, 2654435761, 805459861, 3674653429, 2097192037, 1434869437,
                2165219737)
