"""Sharding rules over named mesh axes (``sharding``: pure functions), and
tensor-parallel serving at run time over a process group (``tp``: each
rank's part of the weights and the pool; ``collectives``)."""
