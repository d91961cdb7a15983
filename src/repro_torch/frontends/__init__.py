"""Frontends: thin translations from user-facing APIs into CVM IR flavors.

* ``dataflow`` — the generic Python collection API (``Context``,
  ``Frame``), translated into ``rel.*`` CVM programs;
* ``sql``      — a small SQL subset parsed onto the dataflow frontend.
"""
