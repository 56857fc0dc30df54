"""Mode "none" of the relation attention kernel (``relation_attention_tc_kernel``):
MEGA's two global-cache launches a step (the merged key and window
enhancement, the global residual stage) at the cell's shapes over their
traced device time, in percent."""

from benchmark.harness import bounds, trace


def shapes(c):
    key, t, g, bn = (c["post_nms_top_n_test"], c["all_frame_interval"], c["global_size"],
                     c["ref_post_nms_top_n"])
    return [(key + t * bn, g * bn), (key, g * bn)]


def read(ctx):
    t = ctx["trace"]
    secs = trace.kernel_s(t, "relation_attention_tc_kernel", exclude="pos") / t["steps"]
    if not secs:
        return None
    a = ctx["config"]["attention"]
    bound = sum(bounds.attention_bound_s(ctx["lanes"], n, m, ctx["config"]["mlp_dim"],
                                         a["groups"], a["embed_dim"])
                for n, m in shapes(ctx["config"]))
    return 100.0 * bound / secs
