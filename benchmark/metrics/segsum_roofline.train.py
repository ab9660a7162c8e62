"""K1's share of its roofline in training: the least time its forward and
backward launches could take (`harness.counts.k1_bound_s_per_step`: the
distinct source rows, ids, pointers and output at 3.35 TB/s, or the adds at
67 TFLOP/s, whichever is larger) over the steps of the traced window,
divided by the summed device time of the unweighted f32 segment-sum kernel
(`segsum_pieces_kernel<float, false, false, false, ...>` of
`sagnn_tpu_torch/csrc/segsum.cu`), found by name in the trace."""

import re

K1 = re.compile(r"segsum_pieces_kernel<\s*float\s*,\s*false\s*,\s*false\s*,"
                r"\s*false\s*,\s*false\s*>")


def read(ctx):
    tr = ctx.get("trace")
    if ctx["kind"] != "train" or tr is None or not ctx.get("steps"):
        return None
    spent = sum(s for name, (s, _) in tr.by_name.items() if K1.search(name))
    if spent <= 0:
        return None
    return 100.0 * ctx["k1_bound_s_per_step"] * ctx["steps"] / spent
