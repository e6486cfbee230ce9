"""CNN front ends (`cnn`: the paper's Fig. 5 student and the ResNet
teacher), the LM zoo's dense families (`lm`) and their shared layers
(`layers`)."""
