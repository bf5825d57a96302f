"""Distributed helpers of the port: the compressed panel wire
(``compression``)."""
