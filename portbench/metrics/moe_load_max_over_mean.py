"""How unevenly the router loads the experts held on the chip: the
program's registry counters over the window, ``lm.moe.max_expert_pairs``
(each MoE call's busiest held expert's pairs, summed) over
``lm.moe.held_pairs`` (the pairs routed to held experts) divided by the
experts held.  1 is an even load; the step waits on the busiest expert.
The recompute of the backward's checkpointed layers counts in both."""


def read(run):
    w = run.window
    held = w.delta("held_pairs")
    if not held:
        return None
    return w.delta("max_expert_pairs") / (held / run.config["num_local_experts"])
