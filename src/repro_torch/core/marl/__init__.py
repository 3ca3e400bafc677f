"""The MARL edge-association controller (paper Section IV), port of
``repro/core/marl``: the env, its structured spaces, the flat and
factorized policies, MADDPG, replay, OU noise and the trainer."""
from repro_torch.core.marl.ddpg import (DDPGConfig, MADDPGState, act,
                                        maddpg_init, maddpg_update,
                                        maddpg_update_impl)
from repro_torch.core.marl.env import (EnvConfig, EnvState, ResetDraws,
                                       StepDraws, compare_with_baselines,
                                       decode_actions, env_reset,
                                       env_soft_reset, env_step, observe,
                                       observe_flat, sample_reset_draws,
                                       sample_step_draws, sharded_env_reset,
                                       sharded_env_step, sharded_observe)
from repro_torch.core.marl.networks import (POLICIES, actor_param_count,
                                            policy_apply, policy_init)
from repro_torch.core.marl.ou_noise import ou_init, ou_step
from repro_torch.core.marl.replay import (Replay, replay_add, replay_init,
                                          replay_row_bytes, replay_sample,
                                          replay_sample_prioritized)
from repro_torch.core.marl.spaces import (Action, Observation, SpaceSpec,
                                          clip_action, compact_obs,
                                          encode_action, flatten_action,
                                          flatten_obs,
                                          obs_from_compact, space_spec,
                                          unflatten_action, zeros_action)
from repro_torch.core.marl.train import (TrainConfig, TrainDraws,
                                         TrainState, sample_train_draws,
                                         train, train_host_loop, train_init,
                                         train_sharded, train_step)
