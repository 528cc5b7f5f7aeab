"""The JAX package's research scripts on the port, one module each under the
script's name, run as `python -m iron_tpu_torch.scripts.<name>` with the
script's flags (or positional arguments) and `--device`:

  singleview_demo          the SDF alone fitted to one photo's silhouette
  tracer_budget_coverage   the tracer's convergent share of a full frame
  diag_torus_stage1        a torus stage 1, its topology, then stage 2 from it
  diag_torus_stage2        stage 2 from an SDF regressed onto the analytic torus
  torus_resume_experiment  stage 2 resumed from a checkpoint, control or grad clip
  silhouette_ab            one stage 1, then stage 2 without and with the
                           silhouette counterweight

Each runs on the CUDA device unless `--device cpu`, prints the lines and
writes the files of its JAX script, and adds the card's name and power limit
(`device`) wherever it prints JSON.  The work lives in plain functions that
take the configurations, the sizes and the device; `main(argv)` builds the
JAX script's defaults.
"""
