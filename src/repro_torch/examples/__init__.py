"""The repository's examples on the port, one module per script of the
reference's ``examples/`` directory and under its file name:

  ``quickstart``         MonoBeast host actors for 3 steps, then the
                         compiled device actors on Catch to a solve
                         (``--replay`` composes off-policy replay)
  ``vtrace_ablation``    V-trace against a user-written uncorrected step
                         under a lagged actor
  ``minatar_gridworld``  the paper's two changes (env and model), the
                         unroll and the learner step as one CUDA graph
  ``lm_rl_100m``         a ~95M-parameter Qwen3-family policy trained with
                         IMPALA on the token-MDP
  ``serve_batched``      the deprecated forwarder to
                         ``repro_torch.launch.serve``

Each runs as ``python -m repro_torch.examples.<name>``, takes the
reference's flags and defaults plus ``--device`` (``cuda`` unless
``--device cpu``: without a GPU it raises, nothing falls back to the CPU),
prints the reference's lines and imports ``torch`` and ``repro_torch``
only. ``main(argv)`` returns what it printed, as numbers.
"""
