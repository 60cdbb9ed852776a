"""recall_at_10: mean tie-aware recall@10 of every query answered in the
window against the reference's exact neighbours (a returned row counts if
its exact distance is within the k-th exact distance)."""


def read(ctx):
    return ctx.numbers.get("recall")
