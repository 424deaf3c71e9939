"""PRNG salts of the key chains the port reproduces.

The values are the reference's (``repro/analysis/salts.py``); a chain
keyed off ``seed ^ SALT`` must use the same salt in both packages or
the draws no longer line up.
"""

# message-addressed latency draws: update by (client, round), broadcast
# by (k, client) on fold_in branches 0/1
LAT_SALT = 0x1A7E9C
# round-completion DP noise: fold_in(PRNGKey(seed ^ NOISE_SALT), tick)
NOISE_SALT = 0x5EED
