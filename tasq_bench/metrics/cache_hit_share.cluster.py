"""PCC cache: admissions decided from the cache over all admissions
(``cache_hit / (cache_hit + cache_miss)``), in %."""


def read(ctx):
    c = ctx.traced.get("counters") or {}
    hit, miss = c.get("cache_hit") or 0, c.get("cache_miss") or 0
    if hit + miss == 0:
        return None
    return 100.0 * hit / (hit + miss)
