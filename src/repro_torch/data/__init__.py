"""Synthetic, resumable token data of the port."""
