"""Placement of host batches on the device (``sharding.place_batch``)."""
