"""Frontends: ``dataflow`` — the generic Python collection API (``Context``,
``Frame``), translated into ``rel.*`` CVM programs."""
