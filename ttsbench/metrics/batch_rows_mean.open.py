"""Batcher: requests per coalesced batch, the mean over the batches the
window formed (`CoalescingBatcher.stats()`, the window minus set-up)."""


def read(ctx):
    return ctx.get("batch_rows_mean")
