"""The yardstick: the card's peaks and each kernel's least time from the
work its call's shapes need, counted from the cell's shapes (the
configuration's sizes and the traffic's batch), never read from the
program. The calls and operations of one unit of work are counted by the
cell's kind (kinds/<kind>.py) from its model family's counts.

Peaks are NVIDIA's data sheet for the H100 SXM (dense): 989 TFLOP/s in
bf16 on the tensor cores, 3.35 TB/s of HBM; tanh.approx.f32 issues 16
results a clock on each of 132 SMs at 1.98 GHz (CUDA C++ Programming
Guide, arithmetic instruction throughput, compute capability 9.0).
"""
PEAK_BF16 = 989e12
HBM_BYTES_PER_S = 3.35e12
SMS, SM_HZ = 132, 1.98e9
TANH_PER_S = 16 * SMS * SM_HZ


def roof_s(flops: float, nbytes: float, peak: float = PEAK_BF16) -> float:
    """The least seconds the card needs for this work: operations at the
    peak or bytes at the memory rate, whichever takes longer."""
    return max(flops / peak, nbytes / HBM_BYTES_PER_S)


def pool_bound_s(N: int, L: int, d: int, h: int, xbytes: int = 2) -> float:
    """The additive pool (N, L, d) -> (N, d) at hidden width h: x read
    once, the f32 mask and weights read once, the output written once; its
    products at the bf16 peak, its N L h tanh at the special-function
    rate (separate units): the longest of the three."""
    flops = 2.0 * N * L * (d * h + h + d)
    nbytes = N * L * d * xbytes + N * L * 4 + (d * h + 2 * h) * 4 \
        + N * d * xbytes
    return max(roof_s(flops, nbytes), N * L * h / TANH_PER_S)


def attention_bound_s(B: int, T: int, D: int, elem: int = 2) -> float:
    """The packed attention forward over B rows of T tokens of width D:
    q k^T and p v (4 B T^2 D operations), q, k, v read and the output
    written once, the (B, T, T) bias read once."""
    return roof_s(4.0 * B * T * T * D, 4 * B * T * D * elem + B * T * T * elem)


def pages(n: int, page: int):
    """The row counts of the pages over n rows."""
    return [min(page, n - s) for s in range(0, n, page)]


# --------------------------------------------------------------------- #
# shapes that every kind of work shares; a unit's own counts are its      #
# kind's (kinds/<kind>.py) and its model family's (reference/<family>.py) #
# --------------------------------------------------------------------- #
def cache_page(cfg: dict) -> int:
    """Rows a page of the repr caches encodes (the model's
    `cache_page_size`, 512 unless the configuration sets it)."""
    return int(cfg["model"]["config"].get("cache_page_size", 512))


def test_rows(cfg: dict) -> int:
    """Rows of the test phase: the fixture's candidate counts are a fixed
    multiset, so their sum is the seed's too."""
    data = cfg["data"]
    n, (lo, hi) = data["test_impressions"], data["candidates"]
    return int(sum(lo + (i * (hi - lo + 1)) // n for i in range(n)))
