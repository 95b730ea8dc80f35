"""The comparison that decides ``correct`` fails the control and every
fault a training cell can have, and passes the program.

The control is the reference put in the program's place with TF32
operands (emulated on the CPU), the precision below the configuration's.
The faults are planted in the program underneath a whole run: an update
that leaves the state unchanged, the loss over half of the batch, and a
batch whose first row is decoded from another sample.  A cell on one card
has no exchange between cards to leave out.  A datagen cell's faults are
a solver step that leaves its state unchanged and an encoded word altered
where the encode produces it."""
import numpy as np
import pytest

from portbench import check, harness
from portbench.calibrate import readings
from portbench.tests.tiny import CELLS, SEED, TRAIN_CELLS, run_tiny, tiny_cell


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(cell):
    c = tiny_cell(cell)
    c.traffic.update(warmup_steps=0, trace_steps=0)
    harness.set_precision(c.config)
    r = readings(c, SEED, "cpu")
    assert check.passed(check.judge(r["program"], c.limits)), r["program"]
    control = {k: v for k, v in r["control"].items() if k in c.limits}
    assert not check.passed(check.judge(control, c.limits)), control
    for fault, numbers in r["faults"].items():
        numbers = {k: v for k, v in numbers.items() if k in c.limits}
        assert not check.passed(check.judge(numbers, c.limits)), (fault, numbers)


def frozen(monkeypatch):
    import repro_torch.train.source as source
    monkeypatch.setattr(source, "adam_update",
                        lambda grads, state, params, cfg, lr_scale=1.0, stacked=False:
                        (params, state))


def half_batch(monkeypatch):
    import repro_torch.train.source as source
    l1, fl1 = source.l1_loss, source.functional_l1_loss

    def half(f):
        return lambda model, *a: f(model, *a[:-2], a[-2][:len(a[-2]) // 2],
                                   a[-1][:len(a[-1]) // 2])
    monkeypatch.setattr(source, "l1_loss", half(l1))
    monkeypatch.setattr(source, "functional_l1_loss", half(fl1))


def wrong_sample(monkeypatch):
    from repro_torch.data.device_store import DeviceResidentCompressedStore
    from repro_torch.data.shards import ShardedCompressedStore
    resident, sharded = DeviceResidentCompressedStore.decode_indices, ShardedCompressedStore.get_batch

    def resident_fault(self, idx):
        idx = idx.clone()
        idx[0] = idx[-1]
        return resident(self, idx)

    def sharded_fault(self, idx):
        idx = np.array(idx)
        idx[0] = idx[-1]
        return sharded(self, idx)
    monkeypatch.setattr(DeviceResidentCompressedStore, "decode_indices", resident_fault)
    monkeypatch.setattr(ShardedCompressedStore, "get_batch", sharded_fault)


@pytest.mark.parametrize("fault", [frozen, half_batch, wrong_sample])
@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_fault_in_the_timed_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    result = run_tiny(cell)
    assert not result["correct"], result["checks"]


def solver_frozen(monkeypatch):
    import repro_torch.sim.solver as solver
    monkeypatch.setattr(solver, "_rk3_step", lambda s, bk, dt, op: s)


def encode_altered(monkeypatch):
    import importlib
    produce = importlib.import_module("repro_torch.datagen.produce")
    make = produce.codec_from_plan

    class Altered:
        def __init__(self, codec):
            self.codec = codec

        def encode_batch(self, xs, tolerances=None):
            cf = self.codec.encode_batch(xs, tolerances)
            cf.payload[0, 0, 0] ^= 1
            return cf
    monkeypatch.setattr(produce, "codec_from_plan", lambda plan: Altered(make(plan)))


@pytest.mark.parametrize("fault", [solver_frozen, encode_altered])
def test_datagen_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    result = run_tiny("pchip-datagen")
    assert not result["correct"], result["checks"]
