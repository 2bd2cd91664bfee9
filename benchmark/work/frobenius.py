"""The needed work of a factorize under the frobenius loss: sklearn's HALS
coordinate descent, one sweep a W half then an H half, per restart and
sweep it runs (its own n_iter).

Per restart-sweep at K components, N cells and G genes: the two data
products (2 N G K operations each), the two grams (2 N K^2 and 2 G K^2)
and the column updates (2 K operations an entry of W and of H, 2 (N + G)
K^2 in all), a division an updated entry ((N + G) K special-function
operations), and each factor read and written once (8 (N + G) K bytes).
X (float32) is read twice a sweep, once for each half, as long as any
restart of the K still sweeps: 8 N G bytes a sweep index up to the K's
largest n_iter.
"""


def work(N: int, G: int, nnz: int, n_gt_eps: int, n_iter_by_k: dict):
    """[(operations, bytes, special-function operations)] a K."""
    out = []
    for k, n_iter in n_iter_by_k.items():
        sweeps = int(sum(n_iter))
        flops = sweeps * (4 * N * G * k + 4 * (N + G) * k * k)
        special = sweeps * (N + G) * k
        nbytes = sweeps * 8 * (N + G) * k + int(max(n_iter)) * 8 * N * G
        out.append((flops, nbytes, special))
    return out
