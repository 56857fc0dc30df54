"""Mode "compute" of the relation attention kernel (``csrc/relation_attention.cu``
``relation_attention_pos_tc_kernel``) at RDN's shapes: the summed least time
of a step's four launches (``harness/bounds.py``'s ``attention_bound_s``
with the uk bytes left out: RDN's attention has no u bias) over their
traced device time, in percent."""

from benchmark.harness import bounds, trace


def shapes(c):
    """(N, M) of RDN's launches, each lane: the base stages (key proposals
    over the window's refs), the advanced stages (the distilled refs over
    them) and the last attention (key proposals over the distilled refs)."""
    a = c["attention"]
    key, refs = c["post_nms_top_n_test"], c["all_frame_interval"] * c["ref_post_nms_top_n"]
    adv = c["all_frame_interval"] * int(c["ref_post_nms_top_n"] * c["ratio"])
    return ([(key, refs)] * a["base_stages"] + [(adv, refs)] * a["advanced_stages"]
            + [(key, adv)])


def bound_s(lanes, n, m, dim, groups, embed):
    """``bounds.attention_bound_s(..., position=True)`` without uk's f32
    (g, M) read a lane."""
    pairs = lanes * n * m
    nbytes = (lanes * (2 * (n + 2 * m) * dim + m + n * dim * 4 + (n + m) * 16)
              + (embed * groups + groups) * 4)
    flops = pairs * groups * (4 * (dim // groups) + 2 * 2 * 32)
    return bounds.bound_s(nbytes, flops, pairs * groups * 8, pairs * (groups + 34))


def read(ctx):
    t = ctx["trace"]
    secs = trace.kernel_s(t, "relation_attention_pos_tc_kernel") / t["steps"]
    if not secs:
        return None
    c = ctx["config"]
    a = c["attention"]
    bound = sum(bound_s(ctx["lanes"], n, m, c["mlp_dim"], a["groups"], a["embed_dim"])
                for n, m in shapes(c))
    return 100.0 * bound / secs
