"""Ownership analysis.  Only the runtime borrow/cid sanitizer is carried
over so far (``Cluster(sanitize=True)`` / ``REPRO_SANITIZE=1`` needs it);
the AST borrow lint and the race certifier are still to port."""
