"""The drivers of the traffic mixes: one module a kind of user loop, named by a mix's ``driver``."""
