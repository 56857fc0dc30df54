"""Mode "compute" of the relation attention kernel (``csrc/relation_attention.cu``
``relation_attention_pos_tc_kernel``): the summed least time of a step's
three launches at the cell's shapes (``harness/bounds.py``) over their
traced device time, in percent."""

from benchmark.harness import bounds, trace


def shapes(c):
    """(N, M) of MEGA's three local/memory stages, each lane."""
    key, t, s = c["post_nms_top_n_test"], c["all_frame_interval"], c["memory_size"]
    bn = c["ref_post_nms_top_n"]
    an = int(bn * c["ratio"])
    return [(key + t * an, t * bn + s * bn), (key + t * an, t * an + s * an),
            (key, t * an + s * an)]


def read(ctx):
    t = ctx["trace"]
    secs = trace.kernel_s(t, "relation_attention_pos_tc_kernel") / t["steps"]
    if not secs:
        return None
    a = ctx["config"]["attention"]
    bound = sum(bounds.attention_bound_s(ctx["lanes"], n, m, ctx["config"]["mlp_dim"],
                                         a["groups"], a["embed_dim"], position=True)
                for n, m in shapes(ctx["config"]))
    return 100.0 * bound / secs
