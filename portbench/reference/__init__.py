"""The plain reference that decides a run's `correct`: float32 PyTorch with
TF32 off, no kernels, no caches, no batching across streams. It imports
nothing of the program under test and takes only what the benchmark made
(the weights, the audio) and what the program served (its tokens and their
frames), which it judges."""
