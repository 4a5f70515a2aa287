"""expert_gemm_roofline: the routed experts' grouped GEMMs' share of
their bound, in %: the least time of the grouped GEMMs that the program
launched in the traced steps, as it counts them where it launches them
(``moe.counts``: the calls and the rows summed over them; each call's
work by ``accounting.expert_gemm`` at the cell's widths), over the
device time of the kernels named here. Nothing where the program has no
such counter or launched none."""
from portbench.trace import kernel_seconds

#: The grouped GEMM's kernels (CUTLASS's grouped problem shape), so that
#: ``elementwise_ms`` leaves them out; the dense cells run none.
KERNELS = ("GroupProblemShape",)


def read(ctx: dict):
    try:
        from kubernetes_tpu_torch.workloads import moe
        counts = moe.counts()
    except (ImportError, AttributeError):
        return None
    calls, rows = counts.get("gemm_calls", 0), counts.get("gemm_rows", 0)
    shape, acc = ctx["shape"], ctx["accounting"]
    if not calls or not hasattr(acc, "expert_gemm"):
        return None
    ops, nbytes = acc.expert_gemm(rows / calls, shape["d_model"],
                                  shape["expert_d_ff"], shape["experts"])
    bound = calls * acc.bound_s(ops, nbytes, ctx["peak_flops"],
                                ctx["peak_bytes"])
    spent = kernel_seconds(ctx, KERNELS)
    return bound / spent * 100.0 if spent > 0 else None
