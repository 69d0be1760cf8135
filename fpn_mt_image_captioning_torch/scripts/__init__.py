"""The port's measurement probes, the counterparts of the TPU probes of the
same names in the repository's ``scripts/``:

    python -m fpn_mt_image_captioning_torch.scripts.probe_launch_overhead
    python -m fpn_mt_image_captioning_torch.scripts.probe_pallas_overhead
    python -m fpn_mt_image_captioning_torch.scripts.probe_grid_cell

Each runs on the CUDA card and raises without one, unless given
``--device=cpu`` (the kernels' plain versions; host times only). Two more
time the decode step's kernels on the card only: ``time_decode_kernels``
(device and host time a call, for one checkout, so two can be compared in
turns) and ``linear_phases`` (where the wgmma linear's time goes, CTA by
CTA)."""
