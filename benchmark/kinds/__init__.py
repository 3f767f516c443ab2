"""One module per kind of traffic.  A traffic file's ``kind`` names the
module here; ``build(config, traffic, seed, device, trace, fault=None,
cache=None)`` returns the cell (``common.Cell``).  ``fault`` and ``cache``
serve the tests and ``benchmark.control``; a benchmark run passes
neither."""
