"""``repro_torch.launch`` — launch modes that run the port's sharded store
end to end (``python -m repro_torch.launch.dryrun_graph``)."""
