"""Serving: factor artifacts (``artifact``), fold-in of new rows
(``foldin``), top-k retrieval (``topk``), request coalescing (``batcher``)
and mesh-sharded serving (``mesh``)."""
