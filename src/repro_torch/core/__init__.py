"""Compression core of the port: pruning, codebooks, compressed FC layers."""
