"""Sizes at which every cell runs on the CPU in seconds: the same code,
fewer rows, documents and requests (and the MiniLM widths unchanged)."""

ROWS = {"rows": {"n": 8192, "modes": 64}, "corpus": {"documents": 8192}}

OVERRIDES = {
    "flat1m.http-poisson": {
        "config": ROWS,
        "cell": {"params": {"rate": 40, "warm_s": 0.5, "connections": 4, "check_requests": 8}}},
    "ivf1m.vectors-q1024": {
        "config": {**ROWS, "index": {"nlist": 64, "nprobe": 8, "train_iters": 4}},
        "cell": {"params": {"batch": 64, "batches": 4, "check_batches": 4}}},
    "flat1m.ingest-stream": {
        "config": ROWS,
        "cell": {"params": {"docs_per_call": 16, "max_calls": 1000, "check_docs": 8,
                             "words": {"median": 12, "lo": 4, "hi": 40}}}},
    "sharded10m.vectors-q1": {
        "config": {"rows": {"n": 4 * 4096, "modes": 64}},
        "cell": {"params": {"batches": 64, "check_batches": 16}}},
}
