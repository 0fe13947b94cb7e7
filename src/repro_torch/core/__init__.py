"""The MPSL core: the three-way split, link compression, losses and the
train step."""
