"""Model code of the port: layers, attention, blocks, the transformer and the facade."""
