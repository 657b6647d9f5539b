"""LM serving: routing imbalance, the busiest expert's slots of each MoE
call (the ``moe_max_expert_slots`` counter, summed over the calls) over
the mean slots an expert (``moe_slots`` over the experts): 1 when every
expert gets as many, the number of experts when one gets all."""


def read(ctx):
    c = ctx.traced.get("counters") or {}
    slots, busiest = c.get("moe_slots"), c.get("moe_max_expert_slots")
    experts = ctx.traced.get("num_experts")
    if not slots or not busiest or not experts:
        return None
    return busiest * experts / slots
