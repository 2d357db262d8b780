"""Model zoo of the port: params, layers, attention, blocks, transformer."""
