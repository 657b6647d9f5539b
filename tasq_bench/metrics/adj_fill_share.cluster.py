"""Cluster control: the share of the model-path adjacency products that
is real work, the program's ``model_adj_entries`` (n squared summed over
the rows the graph model decided, n a row's operators) over its
``model_adj_slots`` (N squared for every row its executables computed,
batch padding included, N the padded node count), in %."""


def read(ctx):
    c = ctx.traced.get("counters") or {}
    entries, slots = c.get("model_adj_entries"), c.get("model_adj_slots")
    if entries is None or not slots:
        return None
    return 100.0 * entries / slots
