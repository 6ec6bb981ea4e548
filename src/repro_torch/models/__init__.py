"""Model code of the port: params, layers, attention, transformer, bridge."""
