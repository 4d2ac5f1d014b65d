"""StreamServer.hot_swap in the port under live streams (after
tests/test_server_hotswap.py): clients push half their audio, the server
swaps its model, the clients push the rest and end. A swap to the same
weights keeps every transcript byte for byte (the port's direct tick loop
is the reference); a swap to other weights keeps the streams going to
OP_ENDED under their ids; a second swap while one is in flight is
refused. The engine's flow arguments pass to the new engine, and the
server records the swap's streams, seconds and snapshot bytes."""

import asyncio

import pytest
import torch

from helpers import tiny_hparams
from test_torch_server import direct_transcript, make_audio

from nemotron_tpu.serving import protocol as P
from nemotron_tpu.serving.client import StreamClient
from nemotron_tpu_torch.api import ASRModel
from nemotron_tpu_torch.serving.server import StreamServer

torch.set_num_threads(1)


def build_model(seed=1):
    return ASRModel.random(tiny_hparams(), seed=seed, device="cpu")


def drive_with_swap(model_a, model_b, audios, **flow):
    """Push half of each stream, hot-swap, push the rest; returns the
    transcripts by client index, the migrated count and the engines."""

    async def run():
        srv = StreamServer(model_a, batch_per_group=4, **flow)
        server = await srv.start("127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        old = srv.engine
        try:
            client = await StreamClient.connect("127.0.0.1", port)
            sids = [await client.start_stream() for _ in audios]
            half = [len(a) // 2 // 1600 * 1600 for a in audios]
            for sid, a, h in zip(sids, audios, half):
                for off in range(0, h, 1600):
                    await client.push(sid, a[off:off + 1600])
            texts = {sid: "" for sid in sids}
            ended = set()

            async def receiver():
                while len(ended) < len(sids):
                    op, rsid, payload = await asyncio.wait_for(
                        client.recv(), timeout=120)
                    if op in (P.OP_TEXT, P.OP_ENDED):
                        texts[rsid] += payload.decode("utf-8", "replace")
                        if op == P.OP_ENDED:
                            ended.add(rsid)
                    elif op == P.OP_ERROR:
                        raise RuntimeError(payload.decode())

            recv_task = asyncio.ensure_future(receiver())
            await asyncio.sleep(0.5)  # the first half runs on the old engine
            n = await asyncio.wait_for(srv.hot_swap(model_b), timeout=120)
            assert srv.engine.model is model_b and srv.engine is not old
            assert srv.last_swap["streams"] == n
            assert srv.last_swap["snapshot_bytes"] > 0
            for sid, a, h in zip(sids, audios, half):
                for off in range(h, len(a), 1600):
                    await client.push(sid, a[off:off + 1600])
                await client.send(P.OP_STREAM_END, sid)
            await recv_task
            client.close()
            return [texts[s] for s in sids], n, old, srv.engine
        finally:
            await srv.stop(server)

    return asyncio.run(run())


@pytest.mark.parametrize("flow", [{}, {"gated_realign": False}],
                         ids=["default", "legacy"])
def test_hot_swap_to_the_same_weights_keeps_transcripts(flow):
    model_a, model_b = build_model(), build_model()  # two instances
    audios = [make_audio(12800, seed=20 + i) for i in range(2)]
    want = [direct_transcript(model_a, a) for a in audios]
    assert all(want), want
    texts, n, old, new = drive_with_swap(model_a, model_b, audios, **flow)
    assert n == 2
    assert texts == want
    assert new.gated_realign == old.gated_realign
    assert old.stats()["streams"] == 0


def test_hot_swap_to_new_weights_streams_continue():
    texts, n, _, new = drive_with_swap(build_model(1), build_model(9),
                                       [make_audio(9600, seed=30)])
    assert n == 1
    assert isinstance(texts[0], str)  # OP_ENDED arrived; content differs
    assert new.stats()["streams"] == 0


def test_hot_swap_refused_while_one_is_in_progress():
    model_a, model_b = build_model(1), build_model(2)

    async def run():
        srv = StreamServer(model_a, batch_per_group=2)
        server = await srv.start("127.0.0.1", 0)
        try:
            first = asyncio.ensure_future(srv.hot_swap(model_b))
            await asyncio.sleep(0)  # let it close the gate
            with pytest.raises(RuntimeError, match="already in progress"):
                await srv.hot_swap(model_b)
            assert await asyncio.wait_for(first, timeout=60) == 0
            assert srv.engine.model is model_b
        finally:
            await srv.stop(server)

    asyncio.run(run())
