"""The run's peak of device memory held by PyTorch's allocator
(``torch.cuda.max_memory_allocated``), set-up included, in GiB."""


def read(ctx):
    if "fit" not in ctx.work or not ctx.memory_peak_bytes:
        return None
    return ctx.memory_peak_bytes / 2.0 ** 30
