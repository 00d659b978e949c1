"""peak_mem_gib: the card's memory that the run's process held at most,
from its start to the window's close (torch.cuda.max_memory_allocated(),
read by the harness from the device's allocator), in GiB. It holds the
port's buffers and activations and the check's copies of the frames it
reads, which are the same in every run."""


def read(run):
    return run.peak_bytes / 2 ** 30 if run.peak_bytes else None
