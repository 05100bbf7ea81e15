"""Model code of the port: layers, attention, block stack, decode step."""
