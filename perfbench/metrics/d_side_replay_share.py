"""d_side_replay_share (%): of the calls to π-GAN's discriminator side of
a loss in the profiled stretch, the share replayed from CUDA graphs: 100 ·
the program's ``zoo.d_side.replay`` spans / its ``zoo.d_side.replay`` and
``zoo.d_side.eager`` spans (runtime/graphs.py). Nothing to read where the
program records neither span."""


def read(ctx):
    names = [name for name, _, _, _ in ctx.trace.host_ops]
    replay = names.count("zoo.d_side.replay")
    calls = replay + names.count("zoo.d_side.eager")
    if not calls:
        return None
    return 100.0 * replay / calls
