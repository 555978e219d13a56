"""Scenes sharded over ranks (``BatchedNavEnv(mesh=)``) against the
unsharded batch: the port's counterpart of ``tests/test_multidev_parity.py``.

Two gloo ranks on the CPU (``parallel.distributed.spawn``) each hold 4 of
the 8 scenes of that test's config (an ORCA crowd, the parity sensors)
and step them 3 times with the env's own draws; each rank also runs the
unsharded 8-scene batch from the same seed and compares its rows.  As the
JAX test holds sharding: bit for bit on sensor_maps, lasers,
angular_maps and the collision and arrive codes, 1e-12 on the vector
fields.  The draw rule (every rank draws what the unsharded batch draws
and keeps its block) is checked by the layouts and the beeps being equal:
robot 0 beeps with probability ``ped_ca_p`` = 0.5, so the beeps read the
draws.  Then ``rollout_with_obs`` runs over the sharded env.  The ranks'
process group times out after 60 s and the test kills them after 150 s,
so a failing rank ends the test.
"""

from img_env_tpu_torch.parallel.distributed import spawn

S = 8
STEPS = 3
# tests/test_multidev_parity.py:45-65, with ped_ca_p 0.5
CFG = {
    "robot": {"total": 2,
              "begin_poses_type": ["range"],
              "begin_poses": [[1.0, 9.0, 1.0, 9.0]],
              "target_poses_type": ["range"],
              "target_poses": [[1.0, 9.0, 1.0, 9.0]]},
    "object": {"total": 3, "shape": ["rectangle"],
               "size_range": [[0.1, 0.4, 0.1, 0.4]],
               "poses_type": ["range"], "poses": [[2.0, 8.0, 2.0, 8.0]]},
    "ped_sim": {"total": 2, "type": "rvoscene", "max_speed": [0.5],
                "begin_poses_type": ["range"],
                "begin_poses": [[1.0, 9.0, 1.0, 9.0]],
                "target_poses_type": ["range"],
                "target_poses": [[1.0, 9.0, 1.0, 9.0]]},
    "global_map": {"resolution": 0.1, "map_file": "room_10.png"},
    "view_map": {"resolution": 0.05, "width": 3, "height": 3},
    "range_total": 64,
    "max_ped": 2,
    "sensor_mode": "parity",
    "ped_ca_p": 0.5,
}


def test_sharded_scenes_bitmatch_unsharded():
    runs = spawn("tests.torch_ranks:sharded_env", 2, [CFG, S, STEPS, 7],
                 backend="gloo", timeout_s=150, pg_timeout_s=60,
                 env={"OMP_NUM_THREADS": "1"})
    for rank, r in enumerate(runs):
        assert r.rc == 0, (rank, r.out[-2000:], r.err[-4000:])
    blocks = [r.result["block"] for r in runs]
    assert blocks == [[0, S // 2], [S // 2, S]]
    for rank, r in enumerate(runs):
        res = r.result
        assert res["layouts"], f"rank {rank}: layouts differ"
        assert res["beeps"], f"rank {rank}: beeps differ"
        assert res["local_beeps_raise"], f"rank {rank}: local beep_u taken"
        assert res["rollout"] == [[2, S // 2, 2], [2, S // 2, 2]]
        assert len(res["errors"]) == STEPS + 1
        for t, errs in enumerate(res["errors"]):
            for field in ("sensor_maps", "lasers", "angular_maps",
                          "is_collisions", "is_arrives"):
                assert errs[field] == 0, (rank, t, field, errs[field])
            for field in ("vector_states", "ped_vector_states", "ped_maps",
                          "step_ds"):
                assert errs[field] <= 1e-12, (rank, t, field, errs[field])
    # the beeps read the draws: some robot 0s beep and some do not
    assert 0 < runs[0].result["beep_count"] < S
