"""Single-device serving: factor artifacts (``artifact``), fold-in of new
rows (``foldin``) and top-k retrieval (``topk``)."""
