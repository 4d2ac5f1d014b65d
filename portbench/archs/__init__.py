"""Architectures: what the harness does differently from one model to
another. A configuration (configs/<config>.json) names its architecture
under "arch", and the harness loads archs/<arch>/__init__.py as a package,
by path (core.Suite.arch), as it loads kinds/ and metrics/. So a model of
another architecture comes as new files: its configuration, its
archs/<arch>/ and its cells.

An architecture's package provides:

    KINDS                          the traffic kinds (kinds/<kind>.py) it
                                   serves; a cell of another kind stops at
                                   set-up with exit code 2
    make_weights(conf, seed, device) -> dict
                                   the weights, made on the device from the
                                   seed in the served types; the same seed
                                   gives the same tensors
    set_blank_bias(w, bias)        the blank's bias (calibrate.py)
    has_q4_0_control(conf)         whether `--control q4_0` has a program
                                   path to read on this configuration
    program_model(conf, w, device, q4_0=False)
                                   the program under test on those weights
                                   (what it has to provide: the docstring of
                                   portbench/tests/tiny_ctc/program.py)
    encoder(w, conf, audio, right_context)
                                   the plain reference's encoder frames
                                   [frames, ...] of int16 audio on the
                                   device, in a streaming mode or, with
                                   None, offline: the mode the kind asks
                                   for (calibration) or the sample's
                                   (judging)
    greedy_rates(w, conf, enc [clips, frames, ...], biases)
                                   tokens per frame that the greedy rule
                                   emits at each of the blank's biases
    frame_seconds(conf)            audio seconds an encoder frame stands for
    served_path(conf, sample)      [(token, frame)] the program served, from
                                   what the kind kept for the sample
    decisions(conf, n_frames, path) -> (decisions, []) or (None, faults)
                                   the decisions the program made, or what
                                   makes the path impossible under the rule
    decision_blocks(w, conf, [(enc, path, decisions)], device)
                                   the reference's logits at every decision,
                                   in blocks of (logits [n, C], choice [n]);
                                   an architecture with two heads yields
                                   blocks of each. The reference honours a
                                   weight dict's "_round" (judge.py's fp8
                                   control)
    model counts                   what the readers of the cells it serves
                                   call: frame_flops, decode_iteration_flops,
                                   stream_window, stream_chunk_flops,
                                   stream_step_flops, stream_linear_calls,
                                   stream_attention_calls,
                                   offline_call_flops, max_seg_mel_frames,
                                   subsampled_len

The file reference.py of an architecture is its plain reference, and
imports nothing of the program and nothing of JAX."""
