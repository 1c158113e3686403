"""Distribution helpers.  Only ``compression`` (the int8 wire of the
serving weight refresh) is ported so far; sharding and pipelining are
still to port."""
