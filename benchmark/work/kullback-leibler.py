"""The needed work of a factorize under the Kullback-Leibler divergence:
sklearn's multiplicative updates at beta 1, W then H, per restart and
iteration it runs (its own n_iter), and its error at the start and at
every tenth iteration.

Per restart-iteration at K components: each half forms W H at X's nonzero
entries (2 K operations and a division each) and adds X / W H times the
other factor into the numerator (2 K operations): 8 K nnz operations and
2 nnz special-function operations for both halves; the updates multiply
and divide every entry of W and H ((N + G) K each); the factors are read
and written once (8 (N + G) K bytes). Per check: W H at the entries of X
above float32's eps with a log each ((2 K + 1) operations, one special).
X (float32) is read twice an iteration and once a check, as long as any
restart of the K still runs: up to the K's largest n_iter.
"""


def work(N: int, G: int, nnz: int, n_gt_eps: int, n_iter_by_k: dict):
    """[(operations, bytes, special-function operations)] a K."""
    out = []
    for k, n_iter in n_iter_by_k.items():
        iters = int(sum(n_iter))
        checks = int(sum(int(n) // 10 + 1 for n in n_iter))
        longest = int(max(n_iter))
        flops = (iters * (8 * k * nnz + (N + G) * k)
                 + checks * (2 * k + 1) * n_gt_eps)
        special = iters * (2 * nnz + (N + G) * k) + checks * n_gt_eps
        nbytes = (iters * 8 * (N + G) * k
                  + (2 * longest + longest // 10 + 1) * 4 * N * G)
        out.append((flops, nbytes, special))
    return out
