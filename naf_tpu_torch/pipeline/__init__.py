"""Decoder entry points of the port."""
