"""The card's peak allocated memory over set-up and window, in GiB
(torch.cuda.max_memory_allocated)."""


def read(run):
    return None if run.memory_peak_bytes is None else run.memory_peak_bytes / 2**30
