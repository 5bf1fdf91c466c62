"""Percent of the (pose, triangle) slots that B1 set up through
MultiModelRefiner's padded model table which are padding: the program's
counters ``pipeline.padded_slots`` (N T_max less the sum of each pose's own
model's triangle count) over ``pipeline.model_slots`` (N T_max), summed
over the process; None where the program has no such counters."""


def read(ctx):
    try:
        from pose_refine_tpu_torch.utils.profiling import counters
    except ImportError:
        return None
    c = counters()
    slots = c.get("pipeline.model_slots")
    if not slots or "pipeline.padded_slots" not in c:
        return None
    return 100.0 * c["pipeline.padded_slots"] / slots
