"""The Photon ML Avro data contract, as Python schema objects (port of
``photon_ml_tpu/io/schemas.py``).

Wire-format parity with the reference module `photon-avro-schemas`
(photon-avro-schemas/src/main/avro/*.avsc): same record/field names,
namespaces, types and defaults, so files written by either system are
readable by the other. Authored here from the documented contract.
"""

NAMESPACE = "com.linkedin.photon.avro.generated"

NAME_TERM_VALUE_AVRO = {
    "name": "NameTermValueAvro",
    "namespace": NAMESPACE,
    "type": "record",
    "fields": [
        {"name": "name", "type": "string"},
        {"name": "term", "type": "string"},
        {"name": "value", "type": "double"},
    ],
}

FEATURE_AVRO = {
    "name": "FeatureAvro",
    "namespace": NAMESPACE,
    "type": "record",
    "fields": [
        {"name": "name", "type": "string"},
        {"name": "term", "type": "string"},
        {"name": "value", "type": "double"},
    ],
}

TRAINING_EXAMPLE_AVRO = {
    "name": "TrainingExampleAvro",
    "namespace": NAMESPACE,
    "type": "record",
    "fields": [
        {"name": "uid", "type": ["null", "string"], "default": None},
        {"name": "label", "type": "double"},
        {"name": "features", "type": {"type": "array", "items": FEATURE_AVRO}},
        {
            "name": "metadataMap",
            "type": ["null", {"type": "map", "values": "string"}],
            "default": None,
        },
        {"name": "weight", "type": ["null", "double"], "default": None},
        {"name": "offset", "type": ["null", "double"], "default": None},
    ],
}

BAYESIAN_LINEAR_MODEL_AVRO = {
    "name": "BayesianLinearModelAvro",
    "namespace": NAMESPACE,
    "type": "record",
    "fields": [
        {"name": "modelId", "type": "string"},
        {"name": "modelClass", "type": ["null", "string"], "default": None},
        {"name": "means", "type": {"type": "array", "items": NAME_TERM_VALUE_AVRO}},
        {
            "name": "variances",
            "type": ["null", {"type": "array", "items": "NameTermValueAvro"}],
            "default": None,
        },
        {"name": "lossFunction", "type": ["null", "string"], "default": None},
    ],
}

LATENT_FACTOR_AVRO = {
    "name": "LatentFactorAvro",
    "namespace": NAMESPACE,
    "type": "record",
    "fields": [
        {"name": "effectId", "type": "string"},
        {"name": "latentFactor", "type": {"type": "array", "items": "double"}},
    ],
}

SCORING_RESULT_AVRO = {
    "name": "ScoringResultAvro",
    "namespace": NAMESPACE,
    "type": "record",
    "fields": [
        {"name": "uid", "type": ["null", "string"], "default": None},
        {"name": "label", "type": ["null", "double"], "default": None},
        {"name": "modelId", "type": "string"},
        {"name": "predictionScore", "type": "double"},
        {"name": "weight", "type": ["null", "double"], "default": None},
        {
            "name": "metadataMap",
            "type": ["null", {"type": "map", "values": "string"}],
            "default": None,
        },
    ],
}

FEATURE_SUMMARIZATION_RESULT_AVRO = {
    "name": "FeatureSummarizationResultAvro",
    "namespace": NAMESPACE,
    "type": "record",
    "fields": [
        {"name": "featureName", "type": "string"},
        {"name": "featureTerm", "type": "string"},
        {"name": "metrics", "type": {"type": "map", "values": "double"}},
    ],
}
