#version 330 core
// Shared fragment stage: gamma + transparency (reference shaders/points.fs
// and the web client's uniforms).
uniform float gamma;
uniform float alpha;
in vec3 v_color;
out vec4 frag_color;
void main() {
  frag_color = vec4(pow(v_color, vec3(1.0 / gamma)), alpha);
}
