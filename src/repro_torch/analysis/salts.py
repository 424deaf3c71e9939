"""PRNG salts of the key chains the port reproduces.

The values are the reference's (``repro/analysis/salts.py``); a chain
keyed off ``seed ^ SALT`` must use the same salt in both packages or
the draws no longer line up.
"""

# message-addressed latency draws: update by (client, round), broadcast
# by (k, client) on fold_in branches 0/1
LAT_SALT = 0x1A7E9C
# drawn per-client latency-table assignments: per-client fold_in
# uniforms inverted through the weight CDF
TABLE_SALT = 0x7AB1E
# availability churn: per-(epoch, client) uniforms for Churn and the
# client factor of RegionalChurn
AVAIL_SALT = 0xA7A1B
# numpy stream for diurnal per-client phase draws
PHASE_SALT = 0xD1A7
# regional-churn shared factor: per-(epoch, region) up-draws
REGION_SALT = 0x2E610
# renewal churn: per-(epoch, client) holding-time draws
RENEW_SALT = 0x9E4A1
# numpy stream for the per-client fleet speed draw (SpeedModel.draw)
SPEED_SALT = 0x5BEED
# round-completion DP noise: fold_in(PRNGKey(seed ^ NOISE_SALT), tick)
NOISE_SALT = 0x5EED
