"""Distributed helpers of the port: the compressed panel wire
(``compression``) and the parameter sharding rules (``sharding``)."""
