"""The CUDA caching allocator's retries per round
(``torch.cuda.memory_stats()["num_alloc_retries"]`` over each round): an
allocation that found no free block, after which the allocator
synchronized, released every cached block and asked the driver again.
Nothing off the card."""


def read(run):
    got = [r.alloc["num_alloc_retries"] for r in run.rounds if r.alloc]
    return sum(got) / len(got) if got else None
