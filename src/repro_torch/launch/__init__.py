"""Launch drivers.  Ported so far: ``serve``."""
