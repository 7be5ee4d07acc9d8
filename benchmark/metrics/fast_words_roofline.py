"""The FAST words kernel's share of its bound: the least time the H100
could take for one batch's work (``yardstick.roofline.fast_words_bound`` of
the batch's own frames) over the kernel's device time per batch in the traced
sub-window, in percent.  The kernel is ``csrc/fast.cu``'s ``fast_kernel``,
which ``fdf_fast_words`` launches once a batch."""

from benchmark.yardstick import roofline

KERNEL = "fast_kernel"


def read(run):
    t = run.trace
    work = getattr(run.driver, "roofline_work", None)
    if t is None or work is None:
        return None
    calls = t.count(lambda n: KERNEL in n)
    if not calls:
        return None
    shape, counted = work()
    bound = roofline.fast_words_bound(shape["frames"], shape["height"], shape["width"],
                                      shape["mode"], shape["count"], counted)
    per_call = t.seconds(lambda n: KERNEL in n) / calls
    return 100.0 * bound["bound_s"] / per_call
